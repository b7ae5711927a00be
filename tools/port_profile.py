#!/usr/bin/env python3
"""Where the device time goes in the PyTorch/CUDA port, on one GPU.

Run from the root of a checkout, on a host with a CUDA device and nvcc:

    python3 tools/port_profile.py [--out FILE] [--parts P,...] [--root DIR] [--label NAME]

``--root`` profiles the ``cudacam_tpu_torch`` of DIR instead of this
checkout's (another commit, unpacked with ``git archive``), so one call on
the card can time two versions in turns on the same inputs (A, B, B, A;
``--label`` names the rows). Fourteen parts (``--parts``; by default all but
``rounds``, ``ff``, ``packs``, ``stages``, ``legacy``, ``loop``, ``probes``
and ``devtime``), each printing one JSON line per workload
(and writing them all to ``--out`` when given):

* ``trace``: ``CannyEngine(device='cuda')`` under torch.profiler, the session
  opened by sentinel launches (``utils.devtime.open_session``, left out of
  every sum; ``whole_session`` says whether each kernel's event count is a
  multiple of the calls): ``process``
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
  kernel and the median µs of one event (the round loop is one
  ``sharded_loop`` event a call);
* ``split``: K11 (``split_converge``). The 8K spiral from its phase-1
  exit (round 32), ``n_split`` 2 and 4: the kernel's CUDA-event ms and
  profiler device µs a call, the seam rounds and the inner rounds of each
  (counted by running the seam rounds one launch each: a budget of one more
  round ends the loop after one seam round), the layout
  (``megakernel.split_layout``; none in a version without it) and a sha256
  of planes and flags. The fixed cost of a seam round: from the same state,
  4 and 16 seam rounds of one inner round each (chunk 1) with 16-step and
  1-step dilation rounds; the slope is the µs a seam round besides the
  launch's own. ``CannyEngine.process`` of the 8K spiral under ``split``.
  The batches under ``split`` at cap 100, x8 1080p (7 scenes and the
  spiral) and x2 8K (scene 0 and the spiral): the kernel from the batch's
  phase-1 exit state in one batched call (the single-frame calls in a
  version without ``converge_packed_split_batched``) against a call a
  frame, and the engine's batch call against single calls, with launches a
  batch call and sha256s. Then the 8K spiral and calm scene 0 under
  torch.profiler with each continuation (two and five passes);
* ``app``: ``CannyApp`` at 1080p BGR under torch.profiler, 64 frames of a
  looped sequence of the eight scenes: host frames through the pinned
  staging buffers (the uploads show as ``Memcpy HtoD``) and
  ``preload_device_loop(8)``;
* ``rounds``: CUDA-event ms (median of the windows) of the hysteresis round
  kernels and the paths that run them, each with a sha256 of its output so
  two versions' outputs can be compared: ``hyst_phase1`` on 1080p scene 0
  (scan_after 64, 16 inner steps, cap 100) and ``hyst_phase2`` on the 1080p
  spiral threshold map from round 12 to the cap (PERF.md's K1 and K2 rows),
  and on the 16000 x 1920 spiral (height segments) from round 2 to a cap of
  30;
  ``CannyEngine.process`` on the 1080p 8-scene stream, the x8 batch of
  seven scenes and the spiral, and the spiral frame at 1080p, 4K and 8K;
  ``threshold_sweep`` with K=16 pairs at 1080p, 4K and 8K; the sharded
  1080p spiral over (1, 2, 2) (``sharded_loop``); the 8K spiral with
  ``continuation='split'`` (K11).

* ``packs``: the core unpack and the threshold sweep's pack step, each row
  with the profiler's device µs of the whole call and of its step (the
  kernels named in ``step_kernels``, whatever a version runs for them:
  ``unpack_core``; ``sweep_pack`` per pair, or ``sweep_pack_all`` and
  ``sweep_seed``), the step's launches a call and its bytes bound, the
  CUDA-event ms a call and a sha256 of the output: ``unpack_core`` of seeded random planes at 8K
  (1, 4, 2); ``ShardedCannyEngine.process`` of 8K scene 0 over (1, 4, 2);
  ``threshold_sweep`` with K=16 pairs on scene 0 at 1080p, 4K and 8K.

* ``ff``: the feed-forward pack and the unpack, each row with the
  profiler's device µs a call (the kernel's own events), the CUDA-event ms a
  call (back-to-back calls through the Python wrapper: for a small kernel
  this is the host's enqueue rate), and a sha256 of the output, so two
  versions can be compared: ``ff_pack`` at 1080p on scene 0 again and again
  (the frame stays in L2), on the 8-scene rotation, on the x8 batch of the
  eight scenes (per frame), at 4K and at 8K; ``ff_pack_export`` on an 8K
  scene over (1, 4, 2); ``unpack`` of scene 0's planes at 1080p, of the x8
  batch's (per frame) and at 8K; the indexed unpack of a K=16 sweep
  (sixteen seeded random planes, a permutation) at 1080p, 4K and 8K.

* ``stages``: the display-stage kernel and the threshold-map pack, each
  row with the profiler's device µs a call (the kernel's own events), the
  CUDA-event ms a call, the host µs a call (calls with no synchronize
  between them), a sha256 of the output and the bytes bound
  (``step_bound_us``): ``ff_stages`` on 1080p scene 0 with five outputs
  (BGR), four (gray), THRESH alone and GRADIENT alone, NMSQ at 1080p, 4K
  and 8K; ``pack_thresh`` of scene 0's threshold map (u8) and keep*g plane
  (nmsq) at each size; ``ff_pack`` at 1080p and 8K and ``sweep_pack_all``
  at K=16 (1080p) beside them; ``process_all`` and ``process(frame,
  THRESH)`` on the 1080p 8-scene stream under torch.profiler (device busy µs
  a frame, idle share, CUDA-event wall ms a frame).

* ``legacy``: K12 (``hysteresis_sweeps``) on scene 0's threshold map at
  1080p, 4K and 8K with block_h 16 and at 1080p with block_h 64: profiler
  device µs a call and the chain kernel's share of them, CUDA-event ms a
  call, sweeps, windows, steps, device µs a step, a sha256 of the map.

* ``loop``: the collective round loop (``sharded_loop``) from the export's
  state on the 8K (1, 4, 2) scene-0 tiles, the 4K x4 (2, 2, 1) batch of
  scenes 0-3, the 1080p spiral over (1, 2, 2), 1080p scene 0 over
  (1, 1, 1) and a 32000 x 512 scene over (1, 2, 1) (tiles that take height
  segments: the loop kernel's other instance) at a budget of 100
  collective rounds: the loop kernel's profiler device µs a call (the mean
  of its own events over five calls, each from a fresh copy of the state,
  and how many the profiler kept), the
  whole call's (every kernel it launches: in a version that refreshes
  before the loop kernel, its two ``exchange_kernel`` launches too) and its
  launches by kernel, CUDA-event ms of the whole call, CUDA-event ms a
  frame of the sharded HYSTER call (``ShardedCannyEngine.process``, windows
  of ten calls) and its launches, a sha256 of the planes, flags and
  rounds; at 8K, the standalone refresh (``halo_exchange`` of FINAL with
  the export's flags and the pending flag) alone: its profiler device µs
  and CUDA-event ms a call; the collective rounds
  and, for each, the phase-1 and phase-2 rounds of every tile, counted on
  the host loop with the saturate's round kernels (one launch a phase,
  their flags read after each round); the inner rounds the loop runs (a
  phase's rounds run while any tile of the phase is active: the most any
  tile takes, summed over the collective rounds); µs a collective round and
  an inner round; and the loop's layout (``megakernel.loop_layout``; none in
  a version without it).

* ``probes``: K13's ballot pack (``probe_pack_ballot``) and ``probe_pack``
  beside it on the 8K mask of ``chip_smoke.py`` (``pack_input(0)``),
  ``probe_pack`` also on that mask one byte past a 16-byte boundary, at
  1080 x 1920, 1080 x 1918 and 4320 x 7696, and K6's ``pack_thresh`` (u8 mode,
  ``pack_walk.cuh``'s column walk) on the same 8K mask as 0 / 255 (its
  FINAL plane is ``probe_pack``'s words), the
  construct loop (``probe_loop``) on the TPU probe's 40 x 256 plane (326
  rounds), ``probe_unpack`` in both modes on the 8K words (135 x 7680,
  ``unpack_input(2)``), and K14's ``swar_stencil``, P1-P4 in SWAR and in
  int32 mode, at 1080p and 8K (``probe_inputs``): CUDA-event ms a call (20
  calls a window, 5 for the loop; median of 5 windows), profiler device µs
  a call (the session opened by ``devtime.open_session``; the events of
  either tree's kernel names), the bound in µs (the larger of the bytes
  over 3.35 TB/s and the operations over 67 T/s), a sha256 of the outputs
  (the loop's with its flags), the loop's rounds and device µs a round, and
  the layouts (``probe_pack_layout_cc``, ``probe_loop_layout``,
  ``probe_unpack_layout_cc``, ``swar_layout_cc``) and the ballot pack's grid
  (``probe_pack_ballot_grid``), none in a version without them.

* ``devtime``: the profiler's busy time checked against itself, on the
  programs of the ``device`` profiling mode (``ff_stages`` to each display
  stage and HYSTER's four kernels, 1080p scene 0): every session of 20
  calls reports each device entry's count (a whole trace holds a multiple
  of 20 of each), the device events that start before the session's first
  host event, and the busy µs a call of every device event and of a whole
  trace (``utils.devtime.whole_session_us``), and ``device_time_ms_per_call``; three interleaved rounds of the six
  programs as the first sessions of the process, then after one session
  followed by 0, 20 000 and 200 000 small launches outside any session;
  then the engine's device-mode ``profiling_table`` after the same; then,
  the card running the HYSTER program in between, every 30 s up to 180 s
  after the first session, the MONO and HYSTER programs in a bare session
  and in one idle for 100 ms on each side of the calls, inside the window
  and before it (whether a wider window keeps the records; how far the
  first device event starts after the first host event and the last ends
  after the synchronize), in one opened by 64 sentinel launches (how many
  of those records the profiler kept), and ``device_time_ms_per_call``.

Imports no jax and nothing of the JAX package: the frame generators are the
port's own (``cudacam_tpu_torch.io.sources``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _root() -> Path:
    """The checkout whose package is profiled: ``--root``, else this one."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    return ap.parse_known_args()[0].root.resolve()


sys.path.insert(0, str(_root()))


@functools.lru_cache(maxsize=None)
def _own_devtime():
    """This checkout's ``utils/devtime.py``, whichever tree ``--root``
    profiles: both trees of an A/B are timed and counted by the same
    accounting (sentinels, whole sessions)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "cudacam_tpu_torch" / "utils" / "devtime.py"
    spec = importlib.util.spec_from_file_location("port_profile_devtime", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cudacam_tpu_torch.app import CannyApp  # noqa: E402
from cudacam_tpu_torch.io.sources import (  # noqa: E402
    SequenceSource, make_scene, make_spiral_frame, make_spiral_thresh,
)
from cudacam_tpu_torch import CannyConfig, CannyStage  # noqa: E402
from cudacam_tpu_torch.engine import CannyEngine, ShardedCannyEngine  # noqa: E402
from cudacam_tpu_torch.ops import bitpack, torch_ops  # noqa: E402
from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs  # noqa: E402
from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack  # noqa: E402
from cudacam_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    canny_mega_pipeline, hyst_phase1, hyst_phase2,
)
from cudacam_tpu_torch.parallel import make_mesh  # noqa: E402

KERNELS = ("ff_pack_kernel", "hyst_kernel<false", "hyst_kernel<true", "unpack_kernel",
           "ff_stages_kernel", "pack_thresh_kernel", "sweep_pack_all_kernel", "sweep_seed_kernel",
           "unpack_core_kernel", "exchange_kernel", "split_kernel", "sweeps_kernel",
           "sharded_loop_kernel")


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
    """``call(x)`` for every x of ``inputs``, ``passes`` times, traced in a
    session opened by sentinel launches (``utils.devtime.open_session``),
    which are left out with any device event from before the session;
    ``whole_session`` says whether every kernel's event count is a whole
    multiple of the calls (``utils.devtime.session_lane``)."""
    devtime = _own_devtime()
    for x in inputs:  # warm-up: build, launch configs, thresholds on the device
        call(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        devtime.open_session()
        t0 = time.perf_counter()
        for _ in range(passes):
            for x in inputs:
                call(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = passes * len(inputs) * frames_per_input
    dev, whole = devtime.session_lane(prof.events(), passes * len(inputs))
    per_kernel = {}
    for e in dev:
        key = next((k for k in KERNELS if k in e.name), e.name)
        per_kernel.setdefault(key, []).append(e.time_range.elapsed_us())
    span = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    return {
        "workload": name, "frames": n, "device_events": len(dev), "whole_session": whole,
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


def split(label: str) -> list:
    """K11 (``split_converge``) on its cases (see the module's docstring)."""
    from cudacam_tpu_torch.ops import cuda as kernels
    from cudacam_tpu_torch.ops.cuda import hysteresis_fused as hf, megakernel

    card = _card()
    rows = []

    def sha(*out):
        return hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in out)).hexdigest()[:16]

    def emit(name, **extra):
        rows.append(dict(workload=name, label=label, card=card, **extra))
        print(json.dumps(rows[-1]), flush=True)

    def kernel_us(run, setup, calls=3):
        """(profiler device µs a call of ``split_kernel``'s events, records kept:
        a whole session keeps calls x the launches a call)."""
        states = iter([setup() for _ in range(calls + 1)])  # the untraced call's, then the traced
        kept = [us for k, us in device_events(lambda: run(next(states)), calls)
                if "split_kernel" in k]
        return (sum(kept) / calls if kept else None), len(kept)

    def batched(f, p, flags, h, n_split, **kw):
        """One call of the batched kernel, or the single-frame calls of a
        version without it."""
        call = getattr(hf, "converge_packed_split_batched", None)
        if call is not None:
            return call(f, p, flags, h, n_split, **kw)
        for b in range(f.shape[0]):
            hf.converge_packed_split(f[b], p[b], flags[b], h, n_split, **kw)

    def singles(f, p, flags, h, n_split, **kw):
        for b in range(f.shape[0]):
            hf.converge_packed_split(f[b], p[b], flags[b], h, n_split, **kw)

    h, w = 4320, 7680
    cfg = CannyConfig(height=h, width=w)
    thr = CannyEngine(cfg, device="cuda")._thresholds()
    spiral = torch.from_numpy(make_spiral_frame(h, w)).cuda()
    f, p, flags = megakernel.canny_mega(spiral, thr, **pipeline_kwargs(cfg))
    it0, ds, cap = int(flags[0, 0]), cfg.hysteresis_inner_steps, cfg.max_hysteresis_iters
    kw = dict(dilate_steps=ds, scan_after=0, max_iters=cap, chunk=megakernel.SPLIT_CHUNK)
    fresh = lambda: (f.clone(), flags.clone())  # noqa: E731
    for n_split in (2, 4):
        run = lambda s: hf.converge_packed_split(s[0], p, s[1], h, n_split, **kw)  # noqa: E731
        out = fresh()
        run(out)
        # The seam rounds one at a time: a budget of one more round ends the
        # loop after one seam round, whose inner cap is the chunk all the same.
        seams, fs, it, changed = [], f.clone(), it0, 1
        while changed and it < cap:
            fl = torch.tensor([[it, 1], [0, 0]], dtype=torch.int32, device="cuda")
            hf.converge_packed_split(fs, p, fl, h, n_split, **dict(kw, max_iters=it + 1))
            nxt, changed = (int(v) for v in fl[1])
            seams.append(nxt - it)
            it = nxt
        us, kept = kernel_us(run, fresh)
        try:
            layout = megakernel.split_layout(1, h, w, n_split, ds)
        except AttributeError:  # a version without the reporter
            layout = None
        emit(f"split_converge 8K spiral from round {it0}, n_split {n_split}",
             event_ms=ms_per_state(run, 1, fresh, reps=5), device_us=us, device_records=kept,
             flags=out[1].tolist(), sha=sha(*out), seam_rounds=len(seams),
             inner_rounds_a_seam_round=seams, inner_rounds=sum(seams),
             seam_by_seam_equal=bool(torch.equal(fs, out[0]) and it == int(out[1][1, 0])),
             layout=layout)
    # The fixed cost of a seam round: from the same state, n seam rounds of
    # one inner round each (chunk 1) at n = 4 and 16; the slope is a seam
    # round's cost without the launch's own, one dilation round of
    # ``dilate_steps`` steps included (1: nearly none of it).
    for steps in (ds, 1):
        per = {}
        for n in (4, 16):
            k1 = dict(dilate_steps=steps, scan_after=0, max_iters=it0 + n, chunk=1)
            run = lambda s: hf.converge_packed_split(s[0], p, s[1], h, 2, **k1)  # noqa: E731
            out = fresh()
            run(out)
            assert out[1][1].tolist() == [it0 + n, 1], out[1].tolist()
            per[n] = ms_per_state(run, 1, fresh, reps=7)
        emit(f"split_converge 8K spiral, seam rounds of one {steps}-step round (chunk 1, n_split 2)",
             event_ms_4=per[4], event_ms_16=per[16],
             us_a_seam_round=(per[16] - per[4]) * 1e3 / 12,
             us_a_launch_besides=(per[4] - 4 * (per[16] - per[4]) / 12) * 1e3)
    e8 = CannyEngine(dataclasses.replace(cfg, continuation="split"), device="cuda")
    emit("process 8K spiral, continuation='split' (ms a call)",
         event_ms=ms_per_call(lambda: e8.process(spiral), reps=5), sha=sha(e8.process(spiral)))
    # Batches: the kernel from the batch's phase-1 exit state, one batched
    # call against a call a frame, and the engine's call against single calls.
    for name, (bh, bw), frames, bcap in (
            ("x8 1080p (7 scenes + spiral)", (1080, 1920),
             lambda: [make_scene(1080, 1920, seed=s) for s in range(7)]
             + [make_spiral_frame(1080, 1920)], 100),
            ("x2 8K (scene 0 + spiral)", (h, w),
             lambda: [make_scene(h, w, seed=0), make_spiral_frame(h, w)], 100)):
        bcfg = CannyConfig(height=bh, width=bw, continuation="split", max_hysteresis_iters=bcap)
        eng = CannyEngine(bcfg, device="cuda")
        x = torch.from_numpy(np.stack(frames())).cuda()
        bf, bp, bfl = megakernel.canny_mega_batched(x, eng._thresholds(), **pipeline_kwargs(bcfg))
        n_split = megakernel.split_count(bh, bw)
        bkw = dict(dilate_steps=bcfg.hysteresis_inner_steps, scan_after=0, max_iters=bcap,
                   chunk=megakernel.SPLIT_CHUNK)
        bfresh = lambda: (bf.clone(), bfl.clone())  # noqa: E731
        one = lambda s: batched(s[0], bp, s[1], bh, n_split, **bkw)  # noqa: E731
        each = lambda s: singles(s[0], bp, s[1], bh, n_split, **bkw)  # noqa: E731
        ob, oe = bfresh(), bfresh()
        one(ob)
        each(oe)
        eng.process(x)
        kernels.reset_launch_counts()
        out = eng.process(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        try:
            layout = megakernel.split_layout(len(x), bh, bw, n_split, bkw["dilate_steps"])
        except AttributeError:
            layout = None
        emit(f"split {name}, cap {bcap}", n_split=n_split, phase1_flags=bfl[:, 0].tolist(),
             flags=ob[1][:, 1].tolist(), batched_equals_single=bool(
                 torch.equal(ob[0], oe[0]) and torch.equal(ob[1], oe[1])),
             kernel_batched_ms=ms_per_state(one, 1, bfresh, reps=5),
             kernel_single_calls_ms=ms_per_state(each, 1, bfresh, reps=5),
             kernel_batched_device_us_and_records=kernel_us(one, bfresh), sha=sha(*ob),
             engine_batch_ms=ms_per_call(lambda: eng.process(x), reps=5),
             engine_single_calls_ms=ms_per_call(lambda: [eng.process(fr) for fr in x], reps=5),
             engine_sha=sha(out), launches=launches, layout=layout)
    # Where the time goes: the 8K frames under the profiler, each continuation.
    scene = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
    for cont in ("split", "kernel"):
        eng = CannyEngine(dataclasses.replace(cfg, continuation=cont), device="cuda")
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


def ms_per_state(fn, n: int, setup, reps: int = 5) -> float:
    """Median over ``reps`` windows of the CUDA-event ms of ``fn(state)``,
    ``n`` calls a window, each on a fresh ``setup()`` state made before it."""
    fn(setup())
    per = []
    for _ in range(reps):
        states = [setup() for _ in range(n)]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for st in states:
            fn(st)
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def rounds(label: str) -> list:
    card = _card()
    rows = []

    def emit(name, ms, out, **extra):
        sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        rows.append(dict(workload=name, label=label, ms=ms, sha=sha, card=card, **extra))

    def frame(make, h, w, **kw):
        return torch.from_numpy(make(h, w, **kw)).cuda()

    h, w = 1080, 1920
    cfg = CannyConfig(height=h, width=w)
    eng = CannyEngine(cfg, device="cuda")
    thr = eng._thresholds()
    kw = dict(dilate_steps=16, max_iters=100)
    zeros = lambda: torch.zeros((2, 2), dtype=torch.int32, device="cuda")  # noqa: E731
    f0, p0 = ff_pack(frame(make_scene, h, w, seed=0), thr)
    out, fl = f0.clone(), zeros()
    hyst_phase1(out, p0, fl, h, scan_after=64, **kw)
    ms = ms_per_state(lambda s: hyst_phase1(s[0], p0, s[1], h, scan_after=64, **kw), 50,
                      lambda: (f0.clone(), zeros()))
    emit("hyst_phase1 1080p scene 0", ms, out, rounds=fl[0].tolist())
    fs, ps = bitpack.pack_pair(frame(make_spiral_thresh, h, w))
    fl = zeros()
    hyst_phase1(fs, ps, fl, h, scan_after=12, **kw)
    out, fl2 = fs.clone(), fl.clone()
    hyst_phase2(out, ps, fl2, h, **kw)
    ms = ms_per_state(lambda s: hyst_phase2(s[0], ps, s[1], h, **kw), 3,
                      lambda: (fs.clone(), fl.clone()))
    emit("hyst_phase2 1080p spiral, round 12 to the cap", ms, out, rounds=fl2.tolist())
    # A plane past the rows one band holds: stacked height segments.
    ht, tk = 16000, dict(dilate_steps=16, max_iters=30)
    ft, pt = bitpack.pack_pair(frame(make_spiral_thresh, ht, w))
    fl = zeros()
    hyst_phase1(ft, pt, fl, ht, scan_after=2, **tk)
    out, fl2 = ft.clone(), fl.clone()
    name = f"hyst_phase2 {ht}x{w} spiral, round 2 to a cap of 30"
    try:
        hyst_phase2(out, pt, fl2, ht, **tk)
    except RuntimeError as e:  # a version that refuses such planes
        rows.append(dict(workload=name, label=label, error=str(e), card=card))
    else:
        ms = ms_per_state(lambda s: hyst_phase2(s[0], pt, s[1], ht, **tk), 1,
                          lambda: (ft.clone(), fl.clone()), reps=3)
        emit(name, ms, out, rounds=fl2.tolist())

    scenes =[frame(make_scene, h, w, seed=s) for s in range(8)]
    spiral = frame(make_spiral_frame, h, w)
    emit("process 1080p 8-scene stream (ms/frame)",
         ms_per_call(lambda: [eng.process(x) for x in scenes], reps=7) / 8,
         torch.stack([eng.process(x) for x in scenes]))
    batch = torch.stack(scenes[:7] + [spiral])
    emit("process 1080p x8 batch, 7 scenes + spiral (ms/frame)",
         ms_per_call(lambda: eng.process(batch), reps=7) / 8, eng.process(batch))
    lows, highs = np.linspace(5, 60, 16).astype(np.int32), np.linspace(20, 180, 16).astype(np.int32)
    for name, (hh, ww) in (("1080p", (h, w)), ("4K", (2160, 3840)), ("8K", (4320, 7680))):
        e = eng if hh == h else CannyEngine(CannyConfig(height=hh, width=ww), device="cuda")
        x = spiral if hh == h else frame(make_spiral_frame, hh, ww)
        emit(f"process {name} spiral frame", ms_per_call(lambda: e.process(x), reps=3), e.process(x))
        x = scenes[0] if hh == h else frame(make_scene, hh, ww, seed=0)
        emit(f"threshold_sweep {name} K=16", ms_per_call(lambda: e.threshold_sweep(x, lows, highs),
                                                         reps=3),
             e.threshold_sweep(x, lows, highs)[0])
    sh = ShardedCannyEngine(cfg, make_mesh(1, 2, 2))
    emit("sharded process 1080p spiral (1, 2, 2)", ms_per_call(lambda: sh.process(spiral[None]),
                                                               reps=3),
         sh.process(spiral[None]))
    e8 = CannyEngine(CannyConfig(height=4320, width=7680, continuation="split"), device="cuda")
    x8 = frame(make_spiral_frame, 4320, 7680)
    emit("process 8K spiral, continuation='split'", ms_per_call(lambda: e8.process(x8), reps=3),
         e8.process(x8))
    return rows


def device_events(fn, calls: int) -> list:
    """(kernel name, device µs) of every device event of ``calls`` calls of
    ``fn`` under the profiler, after one untraced call; the session opens
    with ``utils.devtime``'s first count of sentinel launches, left out."""
    devtime = _own_devtime()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        devtime.open_session()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type.name == "CUDA" and devtime.SENTINEL_KERNEL not in e.name]


def device_us(fn, kernel: str, calls: int) -> float:
    """Profiler device µs a call of ``fn`` in the events of ``kernel``."""
    return sum(us for name, us in device_events(fn, calls) if kernel in name) / calls


def device_us_any(fn, kernels, calls: int) -> float:
    """Profiler device µs a call of ``fn`` in the events whose name holds
    any of ``kernels`` (the names of two versions of one kernel)."""
    return sum(us for name, us in device_events(fn, calls)
               if any(k in name for k in kernels)) / calls


def ff(label: str) -> list:
    from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack_batched, ff_pack_tiles
    from cudacam_tpu_torch.ops.cuda.megakernel import unpack

    card = _card()
    rows = []

    def emit(name, fn, kernel, out, calls, per=1):
        ms = ms_per_call(lambda: [fn() for _ in range(calls)]) / calls / per
        us = device_us(fn, kernel, calls) / per
        sha = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in out)).hexdigest()[:16]
        rows.append(dict(workload=name, label=label, device_us=us, event_ms=ms, sha=sha,
                         card=card))

    thr = torch.tensor([10, 40], dtype=torch.int32, device="cuda")
    scenes = [torch.from_numpy(make_scene(1080, 1920, seed=s)).cuda() for s in range(8)]
    batch = torch.stack(scenes)
    emit("ff_pack 1080p scene 0", lambda: ff_pack(scenes[0], thr), "ff_pack_kernel",
         ff_pack(scenes[0], thr), 50)
    it = iter(range(1 << 30))
    emit("ff_pack 1080p 8-scene rotation", lambda: ff_pack(scenes[next(it) % 8], thr),
         "ff_pack_kernel", [x for s in scenes for x in ff_pack(s, thr)], 48)
    emit("ff_pack 1080p x8 batch (per frame)", lambda: ff_pack_batched(batch, thr),
         "ff_pack_kernel", ff_pack_batched(batch, thr), 10, per=8)
    for name, (h, w) in (("4K", (2160, 3840)), ("8K", (4320, 7680))):
        x = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
        emit(f"ff_pack {name} scene 0", lambda: ff_pack(x, thr), "ff_pack_kernel",
             ff_pack(x, thr), 20)
    eng8 = ShardedCannyEngine(CannyConfig(height=4320, width=7680), make_mesh(1, 4, 2))
    t8 = eng8.pipeline().tiling
    x8 = torch.from_numpy(make_scene(4320, 7680, seed=0)).cuda()[None]
    emit("ff_pack_export 8K (1, 4, 2)", lambda: ff_pack_tiles(x8, thr, t8), "ff_pack_kernel",
         ff_pack_tiles(x8, thr, t8), 20)
    f0, _ = ff_pack(scenes[0], thr)
    emit("unpack 1080p scene 0", lambda: unpack(f0, 1080), "unpack_kernel", [unpack(f0, 1080)], 50)
    fb, _ = ff_pack_batched(batch, thr)
    emit("unpack 1080p x8 batch (per frame)", lambda: unpack(fb, 1080), "unpack_kernel",
         [unpack(fb, 1080)], 20, per=8)
    f8, _ = ff_pack(x8[0], thr)
    emit("unpack 8K scene 0", lambda: unpack(f8, 4320), "unpack_kernel", [unpack(f8, 4320)], 20)
    gen = torch.Generator(device="cuda").manual_seed(16)
    for name, (h, w) in (("1080p", (1080, 1920)), ("4K", (2160, 3840)), ("8K", (4320, 7680))):
        fk = torch.randint(-2**31, 2**31 - 1, (16, -(-h // 32), w), dtype=torch.int32,
                           device="cuda", generator=gen)
        index = torch.randperm(16, device="cuda", generator=gen).to(torch.int32)
        emit(f"indexed unpack, K=16 sweep {name}", lambda: unpack(fk, h, index), "unpack_kernel",
             [unpack(fk, h, index)], 5)
        del fk
        torch.cuda.empty_cache()
    return rows


HBM_BYTES_PER_US = 3.35e6  # the H100 SXM's 3.35 TB/s
OPS_PER_US = 67e6  # its 32-bit peak outside the tensor cores, 67 T/s


def unpack_core_bound_us(t, frames: int = 1) -> float:
    """The bytes bound of ``unpack_core``: the cores' words read once and
    the maps written once (as ``chip_smoke.py`` counts them)."""
    core_words = t.tiles * ((t.e_top + t.h_loc + 31) // 32 - t.e_top // 32) * t.w_loc
    return frames * (4 * core_words + t.tiles * t.h_loc * t.w_loc) / HBM_BYTES_PER_US


def sweep_step_bound_us(h: int, w: int, lows, highs) -> float:
    """The bytes bound of a sweep's pack step: the keep*g plane read once,
    the 2K planes written once, and the planes of the slots the sweep seeds
    (a pair dominated by the one before it in the sorted order) read once."""
    from cudacam_tpu_torch.ops.cuda.canny import sweep_bounds

    b = sweep_bounds(torch.as_tensor(lows, dtype=torch.int32),
                     torch.as_tensor(highs, dtype=torch.int32), CannyConfig(height=h, width=w))
    pairs = sorted((max(lo, 0), max(hi, 0)) for lo, hi in b.view(-1, 2).tolist())[::-1]
    seeded = sum(a[0] >= c[0] and a[1] >= c[1] for a, c in zip(pairs, pairs[1:]))
    plane = 4 * -(-h // 32) * w
    return (4 * h * w + (2 * len(pairs) + seeded) * plane) / HBM_BYTES_PER_US


def packs(label: str) -> list:
    """The core unpack and the sweep's pack step (whatever kernels a
    version runs for them), with sha256s of the outputs."""
    from cudacam_tpu_torch.ops.cuda.megakernel import unpack_core

    card = _card()
    rows = []

    def emit(name, events, calls, ms, out, step=(), bound=None):
        """``step``: name parts of the kernels whose device µs are summed
        as the row's step (all of the call's kernels are summed too)."""
        sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        by = {}
        for n, us in events:
            if any(k in n for k in step):
                key = n.split("(")[-2].split("::")[-1] if "(" in n else n  # the kernel's name
                by.setdefault(key, []).append(us)
        rows.append(dict(
            workload=name, label=label, card=card, event_ms=ms, sha=sha,
            device_us=sum(us for _, us in events) / calls,
            step_us=sum(sum(v) for v in by.values()) / calls,
            step_launches=sum(len(v) for v in by.values()) / calls,
            step_us_by_kernel={k: sum(v) / calls for k, v in by.items()},
            step_launches_by_kernel={k: len(v) / calls for k, v in by.items()},
            step_bound_us=bound))

    eng8 = ShardedCannyEngine(CannyConfig(height=4320, width=7680), make_mesh(1, 4, 2))
    t8 = eng8.pipeline().tiling
    gen = torch.Generator(device="cuda").manual_seed(10)
    f8 = torch.randint(-2**31, 2**31 - 1, (t8.tiles, -(-t8.ext_h // 32), t8.ext_w),
                       dtype=torch.int32, device="cuda", generator=gen)
    out8 = torch.empty((1, 4320, 7680), dtype=torch.uint8, device="cuda")
    run = lambda: unpack_core(f8, out8, t8)  # noqa: E731
    emit("unpack_core 8K (1, 4, 2), seeded random planes", device_events(run, 20), 20,
         ms_per_call(lambda: [run() for _ in range(20)]) / 20, run(), ("unpack_core",),
         unpack_core_bound_us(t8))
    x8 = torch.from_numpy(make_scene(4320, 7680, seed=0)).cuda()[None]
    frame_run = lambda: eng8.process(x8)  # noqa: E731
    emit("sharded HYSTER 8K (1, 4, 2), scene 0 (a frame)", device_events(frame_run, 5), 5,
         ms_per_call(lambda: [frame_run() for _ in range(5)]) / 5, frame_run(), ("unpack_core",),
         unpack_core_bound_us(t8))
    lows, highs = np.linspace(5, 60, 16).astype(np.int32), np.linspace(20, 180, 16).astype(np.int32)
    for name, (h, w) in (("1080p", (1080, 1920)), ("4K", (2160, 3840)), ("8K", (4320, 7680))):
        e = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
        x = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
        sweep = lambda: e.threshold_sweep(x, lows, highs)[0]  # noqa: E731
        n = 5 if h < 4000 else 2
        emit(f"threshold_sweep {name} K=16, scene 0 (a sweep; step: the pack and seeds)",
             device_events(sweep, n), n, ms_per_call(sweep, reps=3), sweep(),
             ("sweep_pack", "sweep_seed"), sweep_step_bound_us(h, w, lows, highs))
        del e, x
        torch.cuda.empty_cache()
    return rows


def stages(label: str) -> list:
    """The display-stage kernel and the threshold-map pack in each mode,
    the "unchanged" rows beside them, and the two streams they serve, with
    sha256s of the outputs (whatever kernels a version runs for them)."""
    from cudacam_tpu_torch.ops.cuda.canny import sweep_bounds
    from cudacam_tpu_torch.ops.cuda.feedforward import FF_STAGES, NMSQ, ff_stages
    from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
        pack_thresh, sweep_order, sweep_pack_all,
    )

    card = _card()
    rows = []

    def digest(out) -> str:
        return hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in out)).hexdigest()[:16]

    def host_us(fn, calls):
        """Host µs a call: ``calls`` calls with no synchronize between them
        (the enqueue rate where the host is slower than the card), median of
        five windows."""
        per = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(per)

    def emit(name, fn, kernel, calls, nbytes):
        """Profiler device µs a call in ``kernel``'s events, CUDA-event ms a
        call, host µs a call, the bytes bound in µs (each input read once,
        each output written once)."""
        ms = ms_per_call(lambda: [fn() for _ in range(calls)]) / calls
        rows.append(dict(workload=name, label=label, card=card,
                         device_us=device_us(fn, kernel, calls), event_ms=ms,
                         host_us=host_us(fn, calls), sha=digest(fn()),
                         step_bound_us=nbytes / HBM_BYTES_PER_US))

    thr = torch.tensor([10, 40], dtype=torch.int32, device="cuda")
    th, gr = (CannyStage.THRESH,), (CannyStage.GRADIENT,)
    for name, (h, w) in (("1080p", (1080, 1920)), ("4K", (2160, 3840)), ("8K", (4320, 7680))):
        frame = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
        px, words = h * w, -(-h // 32) * w
        n = 50 if h == 1080 else 10
        if h == 1080:
            gray = frame[..., 1].contiguous()
            emit("ff_stages five outputs 1080p BGR", lambda: ff_stages(frame, thr, FF_STAGES),
                 "ff_stages_kernel", n, 3 * px + 5 * px)
            emit("ff_stages four outputs 1080p gray",
                 lambda: ff_stages(gray, thr, FF_STAGES[1:]), "ff_stages_kernel", n, px + 4 * px)
            emit("ff_stages THRESH alone 1080p", lambda: ff_stages(frame, thr, th),
                 "ff_stages_kernel", n, 3 * px + px)
            emit("ff_stages GRADIENT alone 1080p", lambda: ff_stages(frame, thr, gr),
                 "ff_stages_kernel", n, 3 * px + px)
        emit(f"ff_stages NMSQ {name}", lambda: ff_stages(frame, None, (NMSQ,)),
             "ff_stages_kernel", n, 3 * px + 4 * px)
        (tmap,) = ff_stages(frame, thr, th)
        (kg,) = ff_stages(frame, None, (NMSQ,))
        kb = thr * thr
        emit(f"pack_thresh u8 {name}", lambda: pack_thresh(tmap), "pack_thresh_kernel", n,
             px + 2 * 4 * words)
        emit(f"pack_thresh nmsq {name}", lambda: pack_thresh(kg, kb), "pack_thresh_kernel", n,
             4 * px + 2 * 4 * words)
        if h != 2160:
            emit(f"ff_pack {name}", lambda: ff_pack(frame, thr), "ff_pack_kernel", n,
                 3 * px + 2 * 4 * words)
        if h == 1080:
            lows = np.linspace(5, 60, 16).astype(np.int32)
            highs = np.linspace(20, 180, 16).astype(np.int32)
            b = sweep_bounds(torch.from_numpy(lows).cuda(), torch.from_numpy(highs).cuda(),
                             CannyConfig(height=h, width=w))
            b = b.view(16, 2)[sweep_order(b).long()].reshape(-1)
            fk = torch.zeros((16, -(-h // 32), w), dtype=torch.int32, device="cuda")
            pk = torch.zeros_like(fk)
            emit("sweep_pack_all K=16 1080p", lambda: (sweep_pack_all(kg, b, fk, pk), fk, pk)[1:],
                 "sweep_pack_all_kernel", n, 4 * px + 2 * 16 * 4 * words)
        del frame, tmap, kg
        torch.cuda.empty_cache()

    eng = CannyEngine(CannyConfig(height=1080, width=1920), device="cuda")
    scenes = [torch.from_numpy(make_scene(1080, 1920, seed=s)).cuda() for s in range(8)]
    for name, call, passes in (
            ("process_all 1080p 8-scene stream", eng.process_all, 3),
            ("process THRESH 1080p 8-scene stream", lambda f: eng.process(f, CannyStage.THRESH), 5)):
        row = trace(name, call, scenes, 1, passes)
        outs = [call(f) for f in scenes]
        outs = [v for o in outs for v in (o.values() if isinstance(o, dict) else [o])]
        row.update(label=label, card=card, sha=digest(outs),
                   busy_us_per_frame=row["busy_us"] / row["frames"],
                   wall_ms_per_frame=ms_per_call(lambda: [call(f) for f in scenes], reps=7) / 8)
        rows.append(row)
    return rows


def legacy(label: str) -> list:
    """K12, the legacy row sweeps, on scene 0's threshold map (the engine's
    default thresholds) at 1080p, 4K and 8K with block_h 16 and at 1080p
    with block_h 64: profiler device µs a call, of which the chain's kernel
    (``sweeps_kernel_chain``; 0 in a version with no kernel of that name),
    CUDA-event ms, the chain's length (sweeps, windows = sweeps x slabs,
    promotion steps) and device µs a step, a sha256 of the map."""
    from cudacam_tpu_torch.ops.cuda import hysteresis as hy
    from cudacam_tpu_torch.ops.cuda.feedforward import ff_stages

    card = _card()
    rows = []
    for name, (h, w), bh in (("1080p", (1080, 1920), 16), ("4K", (2160, 3840), 16),
                             ("8K", (4320, 7680), 16), ("1080p", (1080, 1920), 64)):
        eng = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
        frame = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
        (tmap,) = ff_stages(frame, eng._thresholds(), (CannyStage.THRESH,))
        run = lambda: hy.hysteresis_sweeps(tmap, block_h=bh)  # noqa: E731
        out, info = hy.hysteresis_sweeps(tmap, block_h=bh, return_info=True)
        sweeps, _, steps = info.tolist()
        events = device_events(run, 5)
        us = sum(t for k, t in events if "sweeps_kernel" in k) / 5
        chain_us = sum(t for k, t in events if "sweeps_kernel_chain" in k) / 5
        rows.append(dict(
            workload=f"hyst_sweeps {name} scene 0, block_h {bh}", label=label, card=card,
            device_us=us, chain_device_us=chain_us, event_ms=ms_per_call(run, reps=5),
            sweeps=sweeps, windows=sweeps * -(-h // bh), steps=steps, us_per_step=us / steps,
            sha=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]))
        print(json.dumps(rows[-1]), flush=True)
        del eng, frame, tmap
        torch.cuda.empty_cache()
    return rows


def loop(label: str) -> list:
    """The collective round loop on its cases (see the module's docstring)."""
    from cudacam_tpu_torch.ops import cuda as kernels
    from cudacam_tpu_torch.ops.cuda import megakernel
    from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs
    from cudacam_tpu_torch.ops.cuda.halo import halo_exchange
    from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
    from cudacam_tpu_torch.parallel.packed_halo import packed_hysteresis_loop, sharded_loop

    card = _card()
    rows = []
    for name, (h, w), mesh, frames in (
            ("8K scene 0 (1, 4, 2)", (4320, 7680), (1, 4, 2),
             lambda: [make_scene(4320, 7680, seed=0)]),
            ("4K x4 (2, 2, 1)", (2160, 3840), (2, 2, 1),
             lambda: [make_scene(2160, 3840, seed=s) for s in range(4)]),
            ("1080p spiral (1, 2, 2)", (1080, 1920), (1, 2, 2),
             lambda: [make_spiral_frame(1080, 1920)]),
            ("1080p scene 0 (1, 1, 1)", (1080, 1920), (1, 1, 1),
             lambda: [make_scene(1080, 1920, seed=0)]),
            ("32000x512 scene 0 (1, 2, 1), height segments", (32000, 512), (1, 2, 1),
             lambda: [make_scene(32000, 512, seed=0)])):
        eng = ShardedCannyEngine(CannyConfig(height=h, width=w), make_mesh(*mesh))
        fr = torch.from_numpy(np.stack(frames())).cuda()
        eng.process(fr)
        pipe, cfg = eng.pipeline(), eng.config
        t, g, hk = pipe.tiling, pipe.geo, hyster_kwargs(cfg)
        grid = (len(fr), t.ny, t.nx)
        state = megakernel.mega_export(fr, eng._thresholds(), t, **pipeline_kwargs(cfg))
        budget = cfg.max_hysteresis_iters
        fresh = lambda: tuple(x.clone() for x in state)  # noqa: E731
        run = lambda s: sharded_loop(*s, grid, g, max_rounds=budget, **hk)  # noqa: E731
        out = fresh()
        rounds = int(run(out))
        sha = hashlib.sha256(b"".join(x.cpu().numpy().tobytes() for x in out)
                             + str(rounds).encode()).hexdigest()[:16]
        # The breakdown: the host loop with the saturate's round kernels.
        fc, pc, flc = fresh()
        per = []

        def counting(ff, pp):
            saturate_packed(ff, pp, flc, g.ext_h, **hk)
            r1 = flc[:, 0, 0].tolist()
            per.append((r1, [b - a for a, b in zip(r1, flc[:, 1, 0].tolist())]))
            return flc[:, 1, 1]

        taken = int(packed_hysteresis_loop(fc, pc, flc[:, 0, 1], counting,
                                           lambda x, **k: halo_exchange(x, grid, g, **k), budget))
        inner = sum(max(r1) + max(r2) for r1, r2 in per)
        states = iter([fresh() for _ in range(6)])  # the untraced call's, then five
        events = device_events(lambda: run(next(states)), 5)
        kept = [t_us for k, t_us in events if "sharded_loop_kernel" in k]
        us = statistics.mean(kept)

        def launches(call):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            call()
            torch.cuda.synchronize()
            return {k: n for k, n in kernels.launch_counts().items() if n}

        call_launches = launches(lambda: run(fresh()))
        standalone = {}
        if mesh == (1, 4, 2):
            pend = torch.zeros(1, dtype=torch.int32, device="cuda")
            xch = lambda s: halo_exchange(s, grid, g, grow=state[2][:, 0, 1],  # noqa: E731
                                          pending=pend)
            xs = iter([state[0].clone() for _ in range(21)])
            ev = device_events(lambda: xch(next(xs)), 20)
            standalone = dict(
                halo_exchange_device_us=sum(t_us for k, t_us in ev if "exchange_kernel" in k) / 20,
                halo_exchange_records=sum("exchange_kernel" in k for k, _ in ev),
                halo_exchange_event_ms=ms_per_state(xch, 20, lambda: state[0].clone()))
        try:
            layout = megakernel.loop_layout(grid, g.ext_h, g.ext_w, hk["dilate_steps"])
        except AttributeError:  # a version without the reporter
            layout = None
        frame_ms = ms_per_state(lambda _: eng.process(fr), 10, lambda: None) / len(fr)
        rows.append(dict(
            workload=f"sharded_loop {name}", label=label, card=card, tiles=len(fr) * t.tiles,
            tile_planes=[g.hw, g.ext_w], device_us=us, device_records=len(kept),
            call_device_us=sum(t_us for _, t_us in events) / 5, call_records=len(events),
            call_launches=call_launches, engine_launches=launches(lambda: eng.process(fr)),
            event_ms=ms_per_state(run, 1, fresh, reps=5), frame_ms=frame_ms, sha=sha,
            collective_rounds=rounds,
            host_loop_rounds=taken, inner_rounds=inner,
            us_per_collective_round=us / max(rounds, 1), us_per_inner_round=us / max(inner, 1),
            rounds_per_collective_round=[[max(r1), max(r2)] for r1, r2 in per],
            tile_rounds=per if len(per) <= 4 else per[:2] + per[-2:], layout=layout,
            **standalone))
        print(json.dumps({k: v for k, v in rows[-1].items()
                          if k not in ("rounds_per_collective_round", "tile_rounds")}), flush=True)
        del eng, fr, state
        torch.cuda.empty_cache()
    return rows


def probes(label: str) -> list:
    """K13's ballot pack, ``probe_pack`` and the construct loop (see the
    module's docstring)."""
    from cudacam_tpu_torch.probes import hyster_kernel as hk

    card = _card()
    rows = []

    def sha(*out):
        return hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in out)).hexdigest()[:16]

    mask = torch.from_numpy(hk.pack_input(0, 4320, 7680)).cuda()
    # probe_pack also on the 8K mask one byte past a 16-byte boundary (a
    # slice of a larger buffer), at 1080p, 1080 x 1918 and 8K x 7696.
    buf = torch.zeros(mask.numel() + 32, dtype=torch.uint8, device="cuda")
    at = -buf.data_ptr() % 16 + 1
    shifted = buf[at:at + mask.numel()].view(mask.shape)
    shifted.copy_(mask)
    masks = {"8K mask": mask, "8K mask one byte off": shifted,
             "1080x1920 mask": torch.from_numpy(hk.pack_input(0, 1080, 1920)).cuda(),
             "1080x1918 mask": torch.from_numpy(hk.pack_input(0, 1080, 1918)).cuda(),
             "4320x7696 mask": torch.from_numpy(hk.pack_input(0, 4320, 7696)).cuda()}
    cases = [("probe_pack_ballot", hk.probe_pack_ballot, ("pack_ballot_kernel",), "8K mask")]
    cases += [("probe_pack", hk.probe_pack, ("pack_transpose_kernel", "pack_tile_kernel"), m)
              for m in masks]
    for name, fn, kernels, where in cases:
        x = masks[where]
        h, w = x.shape
        grid = layout = None
        if name == "probe_pack_ballot" and hasattr(hk, "probe_pack_ballot_grid"):
            grid = hk.probe_pack_ballot_grid(h, w)
        if name == "probe_pack" and hasattr(hk, "probe_pack_layout_cc"):
            layout = hk.probe_pack_layout_cc(h, w, x.data_ptr() % 16)
        rows.append(dict(
            workload=f"{name} {where}", label=label, card=card,
            event_ms=ms_per_call(lambda: [fn(x) for _ in range(20)]) / 20,
            device_us=device_us_any(lambda: fn(x), kernels, 20), sha=sha(fn(x)),
            bound_us=(x.numel() + 4 * -(-h // 32) * w) / HBM_BYTES_PER_US, grid=grid,
            layout=layout))
        print(json.dumps(rows[-1]), flush=True)
    del buf, shifted, masks
    # K6's u8 pack (pack_walk.cuh's column walk, a user path) on the same 8K
    # bytes as 0 / 255: its FINAL plane is probe_pack's words.
    from cudacam_tpu_torch.ops.cuda.hysteresis_fused import pack_thresh

    tmap = mask * 255
    final, _ = pack_thresh(tmap)
    rows.append(dict(
        workload="pack_thresh u8 8K mask", label=label, card=card,
        event_ms=ms_per_call(lambda: [pack_thresh(tmap) for _ in range(20)]) / 20,
        device_us=device_us(lambda: pack_thresh(tmap), "pack_thresh_kernel", 20),
        sha=sha(*pack_thresh(tmap)),
        final_equals_probe_pack=torch.equal(final, hk.probe_pack(mask)),
        bound_us=(tmap.numel() + 2 * 4 * final.numel()) / HBM_BYTES_PER_US))
    print(json.dumps(rows[-1]), flush=True)
    del tmap, final
    plane = torch.from_numpy(hk.loop_input()).cuda()
    out, flags = hk.probe_loop(plane)
    n_rounds, changed = flags[0].tolist()
    events = device_events(lambda: hk.probe_loop(plane), 5)
    kernels = ("loop_kernel", "loop_block_kernel")  # grid, resident
    us = sum(t for k, t in events if any(n in k for n in kernels)) / 5
    layout = hk.probe_loop_layout(*plane.shape) if hasattr(hk, "probe_loop_layout") else None
    rows.append(dict(
        workload="probe_loop 40x256", label=label, card=card, rounds=n_rounds, changed=changed,
        event_ms=ms_per_call(lambda: [hk.probe_loop(plane) for _ in range(5)]) / 5,
        device_us=us, us_per_round=us / n_rounds, device_records=len(events),
        sha=sha(out, flags), layout=layout))
    print(json.dumps(rows[-1]), flush=True)

    # K13's unpack in both modes on the 8K words, and K14's four bodies in
    # both modes at 1080p and 8K: a kernel name of either tree matches.
    f8 = torch.from_numpy(hk.unpack_input(2, 4320 // 32, 7680)).cuda()
    for per_word, kernels in ((True, ("unpack_word_kernel",)),
                              (False, ("unpack_byte_kernel", "unpack_runs_kernel"))):
        run = functools.partial(hk.probe_unpack, f8, per_word)
        layout = (hk.probe_unpack_layout_cc(*f8.shape, per_word)
                  if hasattr(hk, "probe_unpack_layout_cc") else None)
        rows.append(dict(
            workload=f"probe_unpack {'a thread per word' if per_word else 'byte mode'} "
                     f"135x7680 words", label=label, card=card,
            event_ms=ms_per_call(lambda: [run() for _ in range(20)]) / 20,
            device_us=device_us_any(run, kernels, 20), sha=sha(run()),
            bound_us=(4 * f8.numel() + 32 * f8.numel()) / HBM_BYTES_PER_US, layout=layout))
        print(json.dumps(rows[-1]), flush=True)
    from cudacam_tpu_torch.probes import i16_swar as sw

    body_ops = {1: 4, 2: 2, 3: 4, 4: 5}  # adds and multiplies a pixel, as chip_smoke.py counts
    for tag, (h, w) in (("1080p", (1080, 1920)), ("8K", (4320, 7680))):
        xi16, xu8 = (torch.from_numpy(a).cuda() for a in sw.probe_inputs(h, w))
        for body in sw.BODIES:
            x = xu8 if body == 4 else xi16
            bound = max(h * w * (x.element_size() + 4) / HBM_BYTES_PER_US,
                        body_ops[body] * h * w / OPS_PER_US)
            layout = sw.swar_layout_cc(h, w, body) if hasattr(sw, "swar_layout_cc") else None
            for swar in (True, False):
                run = functools.partial(sw.swar_stencil, x, body, swar)
                rows.append(dict(
                    workload=f"swar_stencil P{body} {'SWAR' if swar else 'int32'} {tag}",
                    label=label, card=card,
                    event_ms=ms_per_call(lambda: [run() for _ in range(20)]) / 20,
                    device_us=device_us_any(run, ("swar_",), 20), sha=sha(run()),
                    bound_us=bound, layout=layout))
                print(json.dumps(rows[-1]), flush=True)
        del xi16, xu8
    return rows


def _session(fn, calls: int, pad_s: float = 0.0, sentinels: int = 0) -> dict:
    """One profiler session of ``calls`` calls of ``fn`` (warm), idle for
    ``pad_s`` before it and, inside it, before and after the calls, and
    opened by ``sentinels`` throwaway launches (``utils.devtime``): each
    device entry's count (the sentinels' apart), the device events starting
    before the session's first host event, the busy µs a call, and how far
    the first device event starts after the first host event and the last
    ends after the last (the synchronize)."""
    from collections import Counter

    from cudacam_tpu_torch.utils.devtime import SENTINEL_KERNEL, whole_session_us

    fn()
    torch.cuda.synchronize()
    time.sleep(pad_s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(sentinels):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    kept = sum(SENTINEL_KERNEL in e.name for e in events if e.device_type.name != "CPU")
    dev = [e for e in events if e.device_type.name != "CPU" and SENTINEL_KERNEL not in e.name]
    host = [e for e in events if e.device_type.name == "CPU"]
    host0 = min((e.time_range.start for e in host), default=0)
    counts = Counter(e.name for e in dev)
    whole = whole_session_us(events, calls)
    return {"busy_us": sum(e.time_range.elapsed_us() for e in dev) / calls,
            "whole_busy_us": None if whole is None else whole / calls,
            "whole": all(c % calls == 0 for c in counts.values()),
            "early": sum(e.time_range.start < host0 for e in dev),
            "device_end_after_host_end_us": (max(e.time_range.end for e in dev)
                                             - max(e.time_range.end for e in host))
            if dev and host else None,
            "device_start_after_host_start_us": (min(e.time_range.start for e in dev) - host0)
            if dev and host else None,
            "sentinels_kept": kept,
            "counts": {k[:40]: c for k, c in counts.items()}}


def devtime() -> list:
    from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call

    eng = CannyEngine(CannyConfig(height=1080, width=1920), device="cuda")
    x = torch.from_numpy(make_scene(1080, 1920, seed=0)).cuda()
    thr = eng._thresholds()
    programs = [(s.name, eng._sample_program(x, False, s, thr)) for s in CannyStage]
    small = torch.zeros(16, device="cuda")
    rows = []

    def outside(n: int) -> None:
        """One session of the HYSTER program, then ``n`` small launches
        outside any session."""
        _session(programs[-1][1], 3)
        for _ in range(n):
            small.add_(1)
        torch.cuda.synchronize()

    def rounds(label: str) -> None:
        sessions = []
        for _ in range(3):
            for name, run in programs:
                sessions.append(dict(_session(run, 20), program=name))
        fixed = {name: device_time_ms_per_call(run, calls=20) for name, run in programs}
        rows.append({
            "workload": f"devtime: {label}",
            "busy_us_median": {name: statistics.median(t["busy_us"] for t in sessions
                                                       if t["program"] == name)
                               for name, _ in programs},
            "device_time_ms_per_call": fixed,
            "sessions_not_whole": [t for t in sessions if not t["whole"]][:6],
            "sessions_with_early_events": sum(t["early"] > 0 for t in sessions),
            "sessions": len(sessions),
        })

    t0 = time.perf_counter()
    rounds("the first sessions of the process")
    for n in (0, 20000, 200000):
        outside(n)
        rounds(f"after one session and {n} launches outside any session")
    for n in (0, 200000):
        outside(n)
        pe = CannyEngine(CannyConfig(height=1080, width=1920), device="cuda", profiling=True)
        pe.profiling_mode = "device"
        pe.process(x)
        rows.append({"workload": f"devtime: the device-mode table after one session and {n} "
                                 "launches outside any session",
                     "table": pe.profiling_table()})
    # The process ages, the card running the HYSTER program in between: every
    # 30 s up to 180 s after the first session, the MONO and HYSTER programs
    # bare, with 100 ms pads, opened by 64 sentinels, and
    # device_time_ms_per_call.
    from cudacam_tpu_torch.utils import devtime as dt

    for age in range(30, 181, 30):
        while time.perf_counter() - t0 < age:  # the card kept busy meanwhile
            for _ in range(100):
                programs[-1][1]()
            torch.cuda.synchronize()
        refused = dt.refused_sessions
        row = {"workload": f"devtime: {age} s after the first session"}
        for name, run in (programs[0], programs[-1]):
            bare, padded = _session(run, 20), _session(run, 20, pad_s=0.1)
            opened = _session(run, 20, sentinels=64)
            row[name] = {"bare_whole": bare["whole"], "bare_counts": bare["counts"],
                         "padded_whole": padded["whole"],
                         "sentinel_whole": opened["whole"],
                         "sentinels_kept_of_64": opened["sentinels_kept"],
                         "padded_device_end_after_host_end_us":
                             padded["device_end_after_host_end_us"],
                         "padded_device_start_after_host_start_us":
                             padded["device_start_after_host_start_us"],
                         "bare_device_end_after_host_end_us": bare["device_end_after_host_end_us"],
                         "device_time_ms_per_call": dt.device_time_ms_per_call(run, calls=20)}
        row["refused_by_device_time_ms_per_call"] = dt.refused_sessions - refused
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


PARTS = ("trace", "sizes", "sweeps", "sharded", "split", "app", "rounds", "ff", "packs",
         "stages", "legacy", "loop", "probes", "devtime")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--parts", default=",".join(PARTS[:-8]), help=f"comma-separated of {PARTS}")
    ap.add_argument("--root", type=Path, help="profile the package of this checkout")
    ap.add_argument("--label", default="this checkout",
                    help="the label of every part but trace, sizes, sweeps, sharded, app and "
                         "devtime")
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
        rows += split(args.label)
    if "app" in parts:
        rows += app()
    if "rounds" in parts:
        rows += rounds(args.label)
    if "ff" in parts:
        rows += ff(args.label)
    if "packs" in parts:
        rows += packs(args.label)
    if "stages" in parts:
        rows += stages(args.label)
    if "legacy" in parts:
        rows += legacy(args.label)
    if "loop" in parts:
        rows += loop(args.label)
    if "probes" in parts:
        rows += probes(args.label)
    if "devtime" in parts:
        rows += devtime()
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
