"""Benchmark of the port: the full six-stage Canny pipeline's cost per frame
on the card (``cudacam_tpu/benchmark.py`` analog).

Baseline: the reference CUDA app reports ~6 ms/frame for "the entire CUDA
process" on a GTX 1650 at 1080p (reference README.md:5; BASELINE.md).

:func:`main` prints exactly ONE JSON line on standard output:
  {"metric": ..., "value": <ms/frame>, "unit": "ms", "vs_baseline": <speedup>}
vs_baseline > 1 means faster than the reference's 6 ms. Before it, on
standard error: the card's name and power limit (nvidia-smi) and the
kernels' busy time.

Three clocks per frame, reported side by side and never merged (a small
call is host-bound: its events exceed its kernels' busy time):

* ``event``: CUDA events on the stream around a pass of device-resident
  frames, idle gaps included (the reference's own ``cudaEventRecord``
  timers, cannyEdgeH.cu:409-430); the headline on the card;
* ``device``: the kernels' busy time under ``torch.profiler``;
* ``wall``: the host clock to the pass's end.

On the CPU (``device='cpu'``: the plain PyTorch ops) ``event`` and
``device`` are None and the metric is the wall clock, named so. There is no
fallback: ``device='cuda'`` without a card raises. :func:`full_table`
writes the extended table to ``BENCH_TABLE_CUDA.md``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.engine import CannyEngine, ShardedCannyEngine
from cudacam_tpu_torch.engine.engine import resolve_device
from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame, make_spiral_thresh
from cudacam_tpu_torch.ops import cuda as kernels
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import hysteresis_fused
from cudacam_tpu_torch.parallel.mesh import single_device_mesh
from cudacam_tpu_torch.stages import CannyStage
from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call, event_time_ms_per_call

BASELINE_MS = 6.0
#: HBM bandwidth of one H100 (SXM data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
#: Frame size of each label of the table's rows; ``full_table(sizes=...)``
#: overrides them (the CPU tests run the table small).
SIZES: Dict[str, Tuple[int, int]] = {
    "VGA": (480, 640), "1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680),
}
#: The sweep rows' K (low, high) pairs, as the JAX table's.
SWEEP_LOWS = np.linspace(5, 60, 16).astype(np.int32)
SWEEP_HIGHS = np.linspace(20, 180, 16).astype(np.int32)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the CPU
    a line that says there is no card."""
    if dev.type != "cuda":
        return "cpu (the plain PyTorch ops; no card, wall clock only)"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(run_once: Callable[[], object], passes: int, frames_per_pass: int,
             dev: torch.device) -> float:
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run_once()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3 / frames_per_pass)
    return statistics.median(times)


def _measure_ms_per_frame(run_once: Callable[[], object], n_frames: int, dev: torch.device,
                          passes: int = 4) -> Tuple[Optional[float], Optional[float], float]:
    """(event, device, wall) ms per frame of warm passes of ``run_once``
    (each pass ``n_frames`` frames): event and wall the medians of the
    passes, device the busy time over ``passes`` passes. On the CPU event and
    device are None."""
    run_once()  # warm once more
    _sync(dev)
    wall = _wall_ms(run_once, max(2, passes - 1), n_frames, dev)
    if dev.type != "cuda":
        return None, None, wall
    event = statistics.median(
        event_time_ms_per_call(run_once, calls=1, device=dev) for _ in range(passes))
    busy = device_time_ms_per_call(run_once, calls=passes, device=dev)
    return event / n_frames, None if busy is None else busy / n_frames, wall


def _size_tag(h: int, w: int) -> str:
    return "1080p" if (h, w) == SIZES["1080p"] else f"{h}x{w}"


def _fmt(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main(device: Union[str, torch.device] = "cuda", height: int = 1080,
         width: int = 1920) -> None:
    """The headline: ``CannyEngine.process`` streaming ``make_scene`` seeds
    0-7 (0-3 on the CPU), resident on the device, to HYSTER; the median of
    the passes. ``height`` and ``width`` exist for the CPU tests; the
    metric's name states the size and the clock."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    engine = CannyEngine(CannyConfig(height=height, width=width), device=dev)
    engine.warmup()
    # Distinct device-resident frames, streamed back to back: the
    # reference's own number is per-frame time inside a live streaming
    # loop (README.md:5), display never leaving the GPU.
    n_stream = 8 if on_card else 4
    frames = [torch.from_numpy(make_scene(height, width, seed=s)).to(dev)
              for s in range(n_stream)]

    def run_once():
        for f in frames:
            engine.process(f)

    event, busy, wall = _measure_ms_per_frame(run_once, n_stream, dev,
                                              passes=6 if on_card else 3)
    ms, kind = (event, "event") if event is not None else (wall, "wall")
    print(card_line(dev), file=sys.stderr)
    if on_card:
        print(f"device busy {_fmt(busy)} ms/frame (torch.profiler), event {event!r}, "
              f"wall {wall!r} ms/frame", file=sys.stderr)
    print(json.dumps({
        "metric": f"canny_{_size_tag(height, width)}_{kind}_ms_per_frame_{dev.type}",
        "value": round(ms, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / ms, 3),
    }), flush=True)


class _Table:
    """Rows of the extended table, the scenes they share (each made once:
    ``make_scene`` takes ~0.8 s a 1080p frame on the host) and each row's
    launches."""

    def __init__(self, dev: torch.device, sizes: Dict[str, Tuple[int, int]]) -> None:
        self.dev, self.sizes = dev, sizes
        self.tag = dev.type
        self.rows: List[dict] = []
        self._scenes: Dict[Tuple[str, int], torch.Tensor] = {}

    def cfg(self, label: str, **kw) -> CannyConfig:
        h, w = self.sizes[label]
        return CannyConfig(height=h, width=w, **kw)

    def scene(self, label: str, seed: int) -> torch.Tensor:
        key = (label, seed)
        if key not in self._scenes:
            h, w = self.sizes[label]
            self._scenes[key] = torch.from_numpy(make_scene(h, w, seed=seed)).to(self.dev)
        return self._scenes[key]

    def to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.dev)

    def bench(self, name: str, run_once: Callable[[], object], n_frames: int, note: str = "",
              passes: int = 4) -> dict:
        """Launches per frame of one pass (the port's kernels; 0 on the CPU),
        then the three clocks."""
        kernels.reset_launch_counts()
        run_once()
        _sync(self.dev)
        launches = sum(kernels.launch_counts().values()) / n_frames
        event, busy, wall = _measure_ms_per_frame(run_once, n_frames, self.dev, passes)
        row = dict(name=name, event=event, device=busy, wall=wall, launches=launches,
                   note=note)
        self.rows.append(row)
        ms = event if event is not None else wall
        print(f"  {name:46s} event={_fmt(event):>12s} device={_fmt(busy):>12s} "
              f"wall={wall:9.4f} ms {BASELINE_MS / ms:8.1f}x launches={launches:g}  {note}",
              flush=True)
        return row

    def row(self, name: str) -> Optional[dict]:
        return next((r for r in self.rows if r["name"] == name), None)


def full_table(device: Union[str, torch.device] = "cuda",
               out_path: str = "BENCH_TABLE_CUDA.md",
               sizes: Optional[Dict[str, Tuple[int, int]]] = None) -> List[dict]:
    """The extended table, row for row the JAX package's on the port's
    routes, with ``event``, ``device`` and ``wall`` ms/frame and launches per
    frame; written to ``out_path`` and returned. ``sizes`` overrides
    :data:`SIZES` (labels keep their names)."""
    dev = resolve_device(device)
    sizes = dict(SIZES, **(sizes or {}))
    t = _Table(dev, sizes)
    tag = t.tag
    card = card_line(dev)
    print(f"device={dev} {card}", flush=True)

    def stream(eng, frames, stage=CannyStage.HYSTER):
        return lambda: [eng.process(f, stage) for f in frames]

    frames = [t.scene("1080p", s) for s in range(8)]
    cfg = t.cfg("1080p")
    eng = CannyEngine(cfg, device=dev)
    eng.warmup()
    t.bench(f"1080p stream ms/frame [{tag}]", stream(eng, frames), len(frames),
            "make_scene seeds 0-7, resident on the device")

    # Per-stage cumulative (run-to-stage-k).
    for stage in CannyStage:
        eng.warmup(stage)
        t.bench(f"1080p to stage {stage.name:8s} [{tag}]", stream(eng, frames, stage),
                len(frames))

    # Config 1: VGA grayscale frame (the reference's minimal workload).
    eng_vga = CannyEngine(t.cfg("VGA", channels=1), device=dev)
    eng_vga.warmup()
    fv = [t.scene("VGA", s)[..., 0].contiguous() for s in range(8)]
    hv, wv = sizes["VGA"]
    t.bench(f"VGA ({hv}x{wv}) grayscale stream ms/frame", stream(eng_vga, fv), len(fv))

    # Config 2: every intermediary stage buffer kept (process_all).
    frames4 = frames[:4]
    t.bench("1080p all-stage outputs ms/frame", lambda: [eng.process_all(f) for f in frames4],
            len(frames4), "keeps every display buffer (README.md:22 analog)")

    # Config 3: kernel-size / norm variants.
    for ks, norm in ((3, "l2"), (7, "l2"), (5, "l1")):
        engv = CannyEngine(t.cfg("1080p", kernel_size=ks, norm=norm), device=dev)
        engv.warmup()
        t.bench(f"1080p ks={ks} norm={norm} stream ms/frame", stream(engv, frames4), len(frames4))

    # Batched multi-camera streams (config 4). The fixed-scene rows repeat
    # ONE frame, so they measure batching itself against the seed-0 single
    # frame (same convergence depth); the mixed row is the realistic load,
    # where each frame's convergence depth follows its content.
    single = {}
    for label, batches in (("1080p", ((4, False), (8, False), (8, True))),
                           ("4K", ((2, False), (4, False)))):
        e = eng if label == "1080p" else CannyEngine(t.cfg(label), device=dev)
        f0 = t.scene(label, 0)
        e.warmup()
        single[label] = t.bench(
            f"{label} single frame (seed 0) ms/frame", lambda: e.process(f0), 1,
            f"same-session single-frame baseline for the {label} batch rows")
        for b, mixed in batches:
            batch = (torch.stack([t.scene(label, 100 + s) for s in range(b)]) if mixed
                     else torch.stack([f0] * b))
            e.warmup(batch=b)
            kind = "mixed scenes" if mixed else "fixed scene"
            base = single[label]["event"]
            note = ("per-frame convergence depth varies with content" if mixed else
                    "identical frames: measures batching itself, one launch of each kernel "
                    "for the whole batch" + ("" if base is None else
                                             f"; compare the {base:.4f} seed-0 single frame"))
            t.bench(f"{label} batched x{b} ({kind}) ms/frame [{tag}]",
                    lambda: e.process(batch), b, note)

    # Threshold sweep (BASELINE.json config 3): K pairs over one frame.
    k = len(SWEEP_LOWS)
    for label in ("1080p", "4K"):
        e = CannyEngine(t.cfg(label), device=dev)
        fr = t.scene(label, 0)
        t.bench(f"{label} threshold sweep K={k} [{tag}]",
                lambda: e.threshold_sweep(fr, SWEEP_LOWS, SWEEP_HIGHS), 1,
                f"per sweep: ff_stages, sweep_pack_all, K-1 sweep_seed, 2K round kernels, "
                f"one unpack ({3 * k + 2} launches); monotone-seeded tails")

    # Worst-case hysteresis: a frame-long spiral candidate chain (the cap /
    # propagation stress; the reference's analog is its 100-relaunch belt).
    h, w = sizes["1080p"]
    spiral = t.to_dev(make_spiral_thresh(h, w))
    t.bench("hysteresis worst case (1080p spiral)",
            lambda: hysteresis_fused(spiral, max_iters=100,
                                     dilate_steps=cfg.hysteresis_inner_steps,
                                     scan_after=cfg.hysteresis_scan_after), 1,
            "pack_thresh + both round kernels + unpack on a single ~1M-px chain, cut off "
            "at the 100-round cap: an adversarial-input ceiling, not scene behaviour")

    # Worst case through the engine: make_spiral_frame is an adversarial
    # IMAGE (a candidate-band spiral ridge with one seed blob) that escalates
    # into a TAKEN phase-2 continuation, under both continuation forms.
    sp = t.to_dev(make_spiral_frame(h, w))
    for cont in ("kernel", "split"):
        e = CannyEngine(t.cfg("1080p", continuation=cont), device=dev)
        e.warmup()
        t.bench(f"1080p worst case through engine [cont={cont}]", lambda: e.process(sp), 1,
                "real adversarial image -> phase 1 + the taken phase-2 continuation; "
                "'split' is the CannyConfig opt-in (column slices + seam rounds)")
    for label, name in (("4K", "4K worst case through engine"),
                        ("8K", "8K worst case through engine (escalation cliff)")):
        e = CannyEngine(t.cfg(label), device=dev)
        e.warmup()
        spl = t.to_dev(make_spiral_frame(*sizes[label]))
        t.bench(name, lambda: e.process(spl), 1,
                "cap-class input: phase 1 + the whole-frame phase-2 kernel to the "
                "100-round cap", passes=3)

    # The sharded path on the on-card degenerate of "tile-partitioned
    # across chips": a 1x1x1 mesh against the unsharded rows (same scenes).
    sharded = []
    for label, frs in (("1080p", frames),
                       ("4K", [t.scene("4K", s) for s in range(2)]),
                       ("8K", [t.scene("8K", s) for s in range(2)])):
        sh = ShardedCannyEngine(t.cfg(label), single_device_mesh(), device=dev)
        sh.warmup()
        r = t.bench(f"{label} sharded 1x1x1 mesh [{tag}]",
                    lambda: [sh.process(f[None]) for f in frs], len(frs),
                    "ShardedCannyEngine: export pack + phase 1, the one-launch round loop, "
                    "the core unpack; compare the unsharded stream row")
        sharded.append((r, 1, int(sh.pipeline().rounds)))
    sh = ShardedCannyEngine(t.cfg("4K"), single_device_mesh(), device=dev)
    b4 = torch.stack([t.scene("4K", 0)] * 2)
    sh.warmup(batch=2)
    r = t.bench(f"4K batched x2 sharded 1x1x1 mesh [{tag}]", lambda: sh.process(b4), 2,
                "config 4 literally (batched multi-camera 4K through the sharded "
                "pipeline's b axis); compare the unsharded 4K batch rows")
    sharded.append((r, 2, int(sh.pipeline().rounds)))

    # Mega-frames (the north-star axis: scaling frame size).
    for label, note in (("4K", "4x the baseline's pixel count"),
                        ("8K", "16x the baseline's pixel count")):
        hm, wm = sizes[label]
        e = CannyEngine(t.cfg(label), device=dev)
        e.warmup()
        fm = [t.scene(label, s) for s in range(2)]
        t.bench(f"{label} ({hm}x{wm}) stream ms/frame", stream(e, fm), len(fm), note)

    lines = _table_lines(t, card, sizes) + _roofline_lines(t, sizes) + _sharded_lines(sharded)
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {out_path}")
    return t.rows


def _table_lines(t: _Table, card: str, sizes: Dict[str, Tuple[int, int]]) -> List[str]:
    size_list = ", ".join(f"{k} {h}x{w}" for k, (h, w) in sizes.items())
    lines = [
        "# Benchmark table: the PyTorch/CUDA port",
        "",
        f"Card (nvidia-smi name, power limit): {card}. Written by `python -m "
        "cudacam_tpu_torch bench --full`. Baseline: the reference CUDA app, ~6 ms/frame "
        "at 1080p on a GTX 1650 (its README; BASELINE.md). Frame sizes: "
        f"{size_list}.",
        "",
        "ms per frame (per sweep for the sweep rows). `event`: CUDA events on the stream "
        "around a pass of device-resident frames, idle gaps included, median of the "
        "passes. `device`: the kernels' busy time under torch.profiler. `wall`: the "
        "host clock to the pass's end. Small calls are host-bound, so `event` exceeds "
        "`device` there; the two are never merged. `vs 6 ms` divides the unscaled "
        "6 ms 1080p baseline by `event` (by `wall` without a card); 4K and 8K rows "
        "process 4x and 16x the pixels, and the spiral rows are worst-case inputs no "
        "natural scene produces. `launches`: the port's kernel launches per frame of "
        "one pass (0 without a card: the plain ops launch none).",
        "",
        "| Benchmark | event ms/frame | device ms/frame | wall ms/frame | vs 6 ms | "
        "launches / frame | Note |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in t.rows:
        ms = r["event"] if r["event"] is not None else r["wall"]
        lines.append(f"| {r['name']} | {_fmt(r['event'])} | {_fmt(r['device'])} | "
                     f"{r['wall']:.4f} | {BASELINE_MS / ms:.1f}x | {r['launches']:g} | "
                     f"{r['note']} |")
    return lines


def _roofline_lines(t: _Table, sizes: Dict[str, Tuple[int, int]]) -> List[str]:
    """Achieved bytes per second of the MONO pass and of the whole
    pipeline, against the H100's HBM bandwidth: each input byte read once
    and each output byte written once."""
    h, w = sizes["1080p"]
    lines = ["", f"## Roofline ({h}x{w}, measured)", ""]
    found = False
    for name, what, nbytes in (
            (f"1080p to stage {CannyStage.MONO.name:8s} [{t.tag}]",
             "MONO pass (BGR read, mono write)", h * w * 3 + h * w),
            (f"1080p stream ms/frame [{t.tag}]",
             "whole pipeline (BGR read, edge map write)", h * w * 3 + h * w)):
        r = t.row(name)
        ms = None if r is None else (r["device"] if r["device"] is not None else r["event"])
        if ms is None:
            continue
        found = True
        rate = nbytes / (ms * 1e-3)
        lines.append(f"- {what}: {nbytes / 1e6:.2f} MB in {ms * 1e3:.1f} us of device time "
                     f"= {rate / 1e9:.0f} GB/s, {100 * rate / HBM_BYTES_PER_S:.1f}% of the "
                     "H100's 3.35 TB/s.")
    if not found:
        return lines + ["- not measured (no card)."]
    return lines + [
        "- The pipeline is far from its byte bound: its time is the hysteresis round "
        "kernels' dilation steps (PERF.md section 5), not memory traffic.",
    ]


def _sharded_lines(sharded: List[Tuple[dict, int, int]]) -> List[str]:
    """``sharded``: (row, frames a call, collective rounds of the last call)."""
    lines = [
        "",
        "## Sharded (one card, measured)",
        "",
        "Launches per call and collective rounds of the last call, the counters "
        "`chip_smoke.py` holds the sharded path to (a collective round is one "
        "refresh of the tiles' halos and one local saturate, inside the one-launch "
        "round loop on one card).",
        "",
        "| Row | launches / call | collective rounds |",
        "|---|---|---|",
    ]
    for r, frames_per_call, rounds in sharded:
        lines.append(f"| {r['name']} | {r['launches'] * frames_per_call:g} | {rounds} |")
    return lines + [
        "",
        "The N-card projection of the JAX table reads TPU measurements (MEMBER_TILE.json, "
        "a 5 us ICI wire round) and is not carried over: a projection for this card waits "
        "for two or more cards (ROADMAP Queue 1 item 6).",
    ]


def cli_entry(argv: Optional[List[str]] = None) -> int:
    """``python -m cudacam_tpu_torch.benchmark [--full] [--device cpu]``:
    the CLI's ``bench``."""
    from cudacam_tpu_torch.cli import main as cli_main

    return cli_main(["bench"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(cli_entry())
