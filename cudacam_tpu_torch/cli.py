"""Command-line interface of the port (``cudacam_tpu/cli.py`` analog).

Usage:
    python -m cudacam_tpu_torch run --source synthetic:1080x1920 --frames 120 --profile
    python -m cudacam_tpu_torch run --device cpu --source synthetic:64x128 --frames 8
    python -m cudacam_tpu_torch sweep --source synthetic:540x960
    python -m cudacam_tpu_torch sweep --device cpu --lows 5,40 --highs 20,120
    python -m cudacam_tpu_torch bench
    python -m cudacam_tpu_torch bench --full
    python -m cudacam_tpu_torch parity --device cpu --frames 5
    python -m cudacam_tpu_torch info
    python -m cudacam_tpu_torch convert clip.npy clip.rawv

``--device cuda`` (the default) runs the hand-written kernels and raises
when no CUDA device is present: it never runs on the CPU in its place.
``--device cpu`` runs the plain PyTorch versions. ``convert`` is host-only
and writes the same bytes as ``python -m cudacam_tpu convert``. ``run``
takes the JAX CLI's flags except ``--backend`` (the route follows
``--device``); ``--continuation split`` opts into the column-split phase-2
continuation, and ``--trace DIR`` writes a ``torch.profiler`` chrome trace.
``bench`` prints the one JSON line of ``benchmark.main`` (``--full``: the
extended table, written to ``BENCH_TABLE_CUDA.md``). ``parity`` scores the
edge maps against ``cv2.Canny`` and needs OpenCV (``cv2``) on the host.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional

import numpy as np


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the CUDA kernels (raises without a CUDA device); "
                        "cpu: the plain PyTorch versions")


def _device(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    return torch.device(name)


def _add_pipeline_args(p: argparse.ArgumentParser) -> None:
    from cudacam_tpu_torch.stages import CannyStage

    p.add_argument("--stage", default="hyster",
                   choices=[s.name.lower() for s in CannyStage],
                   help="final pipeline stage (cumulative run-to-stage-k)")
    p.add_argument("--low", type=int, default=10, help="low threshold (0-255)")
    p.add_argument("--high", type=int, default=40, help="high threshold (0-255)")
    p.add_argument("--kernel-size", type=int, default=5, choices=(3, 5, 7))
    p.add_argument("--norm", default="l2", choices=("l2", "l1"))
    p.add_argument("--parity", default="reference", choices=("reference", "opencv"),
                   help="threshold domain: reference uint8 magnitudes, or "
                        "cv2.Canny's raw Sobel magnitudes (values carry 1:1)")
    p.add_argument("--continuation", default="auto", choices=("auto", "kernel", "split"),
                   help="phase-2 hysteresis continuation: 'kernel' (= auto) is the "
                        "whole-frame kernel; 'split' converges column slices with "
                        "seam rounds (see CannyConfig.continuation)")


def cmd_run(args: argparse.Namespace) -> int:
    import torch

    from cudacam_tpu_torch.app import CannyApp
    from cudacam_tpu_torch.config import CannyConfig
    from cudacam_tpu_torch.io import open_source
    from cudacam_tpu_torch.stages import CannyStage

    dev = _device(args.device)
    src_kw = {}
    if args.source.startswith(("synthetic", "spiral")) and args.frames:
        src_kw["n_frames"] = args.frames
    source = open_source(args.source, **src_kw)
    source.start()
    h, w, c = source.spec
    cfg = CannyConfig(
        height=h, width=w, channels=c,
        kernel_size=args.kernel_size, norm=args.norm,
        parity=args.parity, continuation=args.continuation,
        low_threshold=args.low, high_threshold=args.high,
    )
    with CannyApp(source, cfg, final_stage=CannyStage[args.stage.upper()],
                  profiling=args.profile, profiling_mode=args.profile_mode,
                  device=dev) as app:
        app.display_mode = args.display
        app.max_fps = args.max_fps
        raw_frames = [] if args.record_input else None

        def on_frame(i: int, out) -> None:
            if raw_frames is not None:  # a copy: on the card the frame may be a pump slot's view
                raw_frames.append(np.array(app._last_input))
            if args.preview != "none" and (i + 1) % args.preview_every == 0:
                print(app.preview(width=args.preview_width, color=args.preview == "ansi"))
                print(f"frame {i + 1}  stage={app.stage.name}  fps={app.fps:.1f}")

        server = None
        if args.serve is not None:
            from cudacam_tpu_torch.io.server import PreviewServer

            server = PreviewServer(app, host=args.serve_host, port=args.serve).start()
            print(f"preview: http://{args.serve_host}:{server.port}/")

        app.warmup()  # set-up outside the timed loop
        if args.device_loop:
            got = app.preload_device_loop(args.device_loop)
            print(f"device loop: cycling {got} preloaded frames")
        keys = None
        if args.interactive:
            from cudacam_tpu_torch.io.keys import KeyController

            keys = KeyController(app)
            keys.start()

        tracer = app.engine.trace(args.trace) if args.trace else contextlib.nullcontext()
        t0 = time.perf_counter()
        n = 0
        try:
            with tracer:
                if args.record:
                    p = app.record(args.frames, args.record, on_frame=on_frame)
                    if p.endswith(".npy"):
                        n = int(np.load(p, mmap_mode="r").shape[0])
                    else:  # video: count via the meter
                        n = app.status()["frames"]
                else:
                    n = app.run(args.frames, on_frame=on_frame)
                    if dev.type == "cuda":  # the clock stops when the last frame is done
                        torch.cuda.synchronize(dev)
        except KeyboardInterrupt:
            # Ctrl-C ends the run but must not lose recordings.
            print("\ninterrupted", file=sys.stderr)
            n = n or (len(raw_frames) if raw_frames else 0)
        finally:
            dt = time.perf_counter() - t0
            if keys is not None:
                keys.stop()
            if server is not None:
                server.stop()
            if raw_frames:
                from cudacam_tpu_torch.io import write_rawv

                write_rawv(args.record_input, np.stack(raw_frames))
                print(f"recorded {len(raw_frames)} input frames to {args.record_input}")
        if args.trace:
            print(f"profile written to {args.trace}")
        if args.save:
            app.save_frame(args.save)
            print(f"saved {args.save}")
        if args.profile:
            print(app.profiling_table())
        print(f"{n} frames in {dt:.3f}s "
              f"({1e3 * dt / max(1, n):.3f} ms/frame, {n / dt:.1f} fps) "
              f"device={app.engine.device} stage={app.stage.name}")
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    from cudacam_tpu_torch import __version__, probe
    from cudacam_tpu_torch.config import GAUSSIAN_TAPS
    from cudacam_tpu_torch.stages import CannyStage

    dev = _device(args.device)
    info = {
        "version": __version__,
        **probe(),
        "selected_device": str(dev),
        "backends": ["cuda (hand-written sm_90a kernels)", "cpu (plain PyTorch)"],
        "kernel_sizes": sorted(GAUSSIAN_TAPS),
        "default_thresholds": [10, 40],
        "stages": [s.name for s in CannyStage],
        "commands": ["run", "sweep", "bench", "parity", "info", "convert"],
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from cudacam_tpu_torch import benchmark

    dev = _device(args.device)
    if args.full:
        benchmark.full_table(device=dev)
    else:
        benchmark.main(device=dev)
    return 0


def cmd_sweep(args: argparse.Namespace) -> int:
    from cudacam_tpu_torch.config import CannyConfig
    from cudacam_tpu_torch.engine import CannyEngine
    from cudacam_tpu_torch.io import open_source

    dev = _device(args.device)
    lows = [int(v) for v in args.lows.split(",")]
    highs = [int(v) for v in args.highs.split(",")]
    if args.zip_pairs:
        if len(lows) != len(highs):
            print("--zip requires equal-length lists", file=sys.stderr)
            return 2
        pairs = [(lo, hi) for lo, hi in zip(lows, highs) if lo <= hi]
    else:
        pairs = [(lo, hi) for lo in lows for hi in highs if lo <= hi]
    with open_source(args.source) as src:
        frame = src.read()
    h, w, c = frame.shape[0], frame.shape[1], (frame.shape[2] if frame.ndim == 3 else 1)
    eng = CannyEngine(CannyConfig(height=h, width=w, channels=c), device=dev)
    maps, counts = eng.threshold_sweep(frame, [p[0] for p in pairs], [p[1] for p in pairs])
    counts = counts.cpu().numpy()
    rows = [
        {"low": lo, "high": hi, "edge_px": int(n),
         "edge_frac": round(float(n) / (h * w), 5)}
        for (lo, hi), n in zip(pairs, counts)
    ]
    print(json.dumps({"frame": f"{h}x{w}", "device": str(eng.device), "sweep": rows}, indent=2))
    if args.save_dir:
        from cudacam_tpu_torch.io.preview import save_png

        arr = maps.cpu().numpy()
        for (lo, hi), m in zip(pairs, arr):
            save_png(f"{args.save_dir}/edges_lo{lo}_hi{hi}.png", m)
        print(f"saved {len(pairs)} maps to {args.save_dir}")
    return 0


def cmd_parity(args: argparse.Namespace) -> int:
    """Structural parity report against cv2.Canny (the reference's own
    manual correctness check, README.md:16, done as a measured tool)."""
    from cudacam_tpu_torch.parity import parity_report

    rep = parity_report(
        n_frames=args.frames,
        height=args.height,
        width=args.width,
        low=args.low,
        high=args.high,
        source_spec=args.source,
        device=_device(args.device),
    )
    print(json.dumps(rep, indent=2))
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    from cudacam_tpu_torch.io import open_source, write_rawv

    cap = args.frames or None
    frames = []
    with open_source(args.src) as src:
        try:
            for i, f in enumerate(src):
                if cap is not None and i >= cap:
                    break
                frames.append(f)
        except KeyboardInterrupt:
            print(f"\ninterrupted after {len(frames)} frames", file=sys.stderr)
    if not frames:
        print("no frames captured", file=sys.stderr)
        return 1
    arr = np.stack(frames)
    if args.dst.endswith(".rawv"):
        write_rawv(args.dst, arr)
    elif args.dst.endswith(".npy"):
        np.save(args.dst, arr)
    else:
        print("dst must end in .npy or .rawv", file=sys.stderr)
        return 2
    print(f"wrote {len(frames)} frames {arr.shape[1:]} to {args.dst}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cudacam_tpu_torch",
        description="Real-time Canny edge detection on PyTorch + hand-written CUDA kernels",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="stream frames through the pipeline")
    pr.add_argument(
        "--source", default="synthetic:720x1280",
        help="synthetic[:HxW] | spiral[:HxW] | webcam[:IDX] | video:PATH | seq:PATH | "
             "rawv:PATH | multi:N*SPEC (bare *.npy/*.rawv paths work too)",
    )
    pr.add_argument("--frames", type=int, default=30,
                    help="frame count (0 = until source ends)")
    _add_pipeline_args(pr)
    _add_device_arg(pr)
    pr.add_argument("--profile", action="store_true",
                    help="per-stage timing table (times every frame per stage)")
    pr.add_argument("--profile-mode", default="auto",
                    choices=("auto", "stages", "cumulative", "device"),
                    help="per-stage timing source with --profile: 'cumulative' (auto "
                         "on cuda) times the run-to-stage programs with CUDA events, "
                         "'stages' (auto on cpu; --device cpu only) the stage ops one "
                         "by one, 'device' samples the kernels' busy time under "
                         "torch.profiler once")
    pr.add_argument("--interactive", action="store_true",
                    help="terminal key controls on the running stream "
                         "(space=pause, s=stage, p=pipeline, [/]/{/}= "
                         "thresholds, m=mode, q=quit); needs a tty")
    pr.add_argument("--device-loop", type=int, default=None, metavar="N",
                    help="preload N frames to the device once and cycle "
                         "them (no upload per frame; replayable sources only)")
    pr.add_argument("--max-fps", type=float, default=None,
                    help="pace the loop to at most this rate (the reference "
                         "is vsync-locked ~60; default unpaced)")
    pr.add_argument("--display", default="edges",
                    choices=("edges", "raw", "split", "overlay"),
                    help="composition for preview/save/serve/video-record")
    pr.add_argument("--preview", default="none", choices=("none", "ascii", "ansi"))
    pr.add_argument("--preview-every", type=int, default=10)
    pr.add_argument("--preview-width", type=int, default=96)
    pr.add_argument("--save", default=None, help="save last output as PNG")
    pr.add_argument("--record", default=None, help="record outputs to .npy")
    pr.add_argument("--trace", default=None,
                    help="capture a torch.profiler chrome trace into this directory")
    pr.add_argument("--record-input", default=None, metavar="PATH.rawv",
                    help="also capture the raw input frames as a replayable "
                         ".rawv stream")
    pr.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live MJPEG preview + status page on PORT")
    pr.add_argument("--serve-host", default="127.0.0.1",
                    help="preview bind address (default localhost-only; set "
                         "0.0.0.0 to expose the unauthenticated stream)")
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser(
        "convert",
        help="convert recorded frames between .npy and the native .rawv "
             "stream format (or grab them from any source)",
    )
    pc.add_argument("src", help="input: .npy, .rawv, or any source spec")
    pc.add_argument("dst", help="output: .npy or .rawv")
    pc.add_argument("--frames", type=int, default=30,
                    help="frame cap (default 30; 0 = until the source ends — "
                         "endless sources like webcam then need Ctrl-C)")
    pc.set_defaults(fn=cmd_convert)

    pi = sub.add_parser("info", help="environment / device / config surface")
    _add_device_arg(pi)
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser(
        "sweep",
        help="threshold sweep: K (low,high) pairs over one frame, one feed-forward pass",
    )
    ps.add_argument("--source", default="synthetic:540x960")
    ps.add_argument("--lows", default="5,10,20,40",
                    help="comma-separated low thresholds")
    ps.add_argument("--highs", default="20,40,80,160",
                    help="comma-separated high thresholds (crossed with lows)")
    ps.add_argument("--zip", action="store_true", dest="zip_pairs",
                    help="pair lows[i] with highs[i] instead of the cross product")
    ps.add_argument("--save-dir", default=None, help="save each edge map as PNG")
    _add_device_arg(ps)
    ps.set_defaults(fn=cmd_sweep)

    pb = sub.add_parser("bench", help="run the standard benchmark (one JSON line)")
    pb.add_argument("--full", action="store_true",
                    help="extended table -> BENCH_TABLE_CUDA.md")
    _add_device_arg(pb)
    pb.set_defaults(fn=cmd_bench)

    pp = sub.add_parser("parity", help="structural parity report vs cv2.Canny (needs cv2)")
    pp.add_argument("--frames", type=int, default=5)
    pp.add_argument("--height", type=int, default=540)
    pp.add_argument("--width", type=int, default=960)
    pp.add_argument("--low", type=int, default=10)
    pp.add_argument("--high", type=int, default=40)
    pp.add_argument("--source", default=None,
                    help="optional source spec (default: synthetic scenes)")
    _add_device_arg(pp)
    pp.set_defaults(fn=cmd_parity)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "run" and args.frames == 0:
        args.frames = None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
