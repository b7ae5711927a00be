"""Readings the check's limits are set from, for one cell, on many seeds in
one process:

* the program's: a short closed-loop window at the cell's own load, its
  sampled outputs compared with the reference (as every run compares them);
* the control's: the reference computed in float16 (mono, Gaussian and
  Sobel), put in the program's place for the same sampled calls.

    python3 benchmarks/control.py --workload cam1080p.stream_calm \
        --seeds 11,12,13 --seconds 2

Prints one JSON line a seed, then a summary line: the largest program
reading and the smallest control reading of each number compared.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmarks import harness, scenes

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    suite = harness.Suite.load()
    cell = suite.cell(args.workload)
    call = harness.make_program(cell.config, device)
    canny = cell.config["canny"]
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inputs = scenes.make_inputs(cell.traffic, canny["height"], canny["width"], seed, device)
        loop = harness.Loop(call, inputs, cell.traffic.in_flight, device,
                            scenes.reservoir(random.Random(seed ^ 0x5EED),
                                             cell.traffic.check_calls))
        loop.run(time.perf_counter() + args.seconds)
        loop.drain()
        kept = dict(loop.kept)
        got = harness.check(cell.config, inputs, kept)
        ctl = harness.check(cell.config, inputs, kept, chain_dtype=torch.float16)
        program.append(got)
        control.append(ctl)
        print(json.dumps({"seed": seed, "calls": loop.i, "program": got, "control": ctl,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del loop, kept, inputs
    summary = {k: {"program_max": max(p[k] for p in program),
                   "control_min": min(c[k] for c in control)}
               for k in ("mismatched_px", "frames_mismatched")}
    print(json.dumps({"workload": args.workload, "seeds": len(program), "summary": summary,
                      "card": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
