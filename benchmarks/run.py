"""Run one cell of the benchmark once and print its result line.

    python3 benchmarks/run.py --workload cam1080p.stream_calm --seed 7 \
        --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``run``, and last ``checks``: each number the check
compared, with its limit. The same numbers are the last lines of standard
error. Exits 2 without a result when the machine has fewer CUDA cards than
the cell asks for, and 3 when a forbidden module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_limit() -> str:
    """The card's name, power limit, SM clock, power draw and temperature,
    as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[0] = str(ROOT)  # the repository, not this folder
    import torch

    from benchmarks import harness

    suite = harness.Suite.load()
    chips = suite.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(suite, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}", file=sys.stderr)
        return 3
    result["run"]["card"] = card_limit()
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} ({c['rule']} {c['limit']})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
