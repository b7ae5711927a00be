"""Command-line interface of the port (``cudacam_tpu/cli.py`` analog).

Usage:
    python -m cudacam_tpu_torch sweep --source synthetic:540x960
    python -m cudacam_tpu_torch sweep --device cpu --lows 5,40 --highs 20,120
    python -m cudacam_tpu_torch info
    python -m cudacam_tpu_torch convert clip.npy clip.rawv

``--device cuda`` (the default) runs the hand-written kernels and raises
when no CUDA device is present: it never runs on the CPU in its place.
``--device cpu`` runs the plain PyTorch versions. ``convert`` is host-only
and writes the same bytes as ``python -m cudacam_tpu convert``. ``run``,
``parity`` and ``bench`` are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
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
    }
    print(json.dumps(info, indent=2))
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
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
