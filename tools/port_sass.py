#!/usr/bin/env python3
"""Instruction counts of the port's kernels, from the SASS nvcc built.

Run from the root of a checkout, on a host with the CUDA toolkit:

    python3 tools/port_sass.py [--root DIR] [--kernels NAME,...] [--out FILE]

Builds (or loads) the kernel library of ``cudacam_tpu_torch`` in DIR (this
checkout by default; another commit unpacked with ``git archive`` to compare
two versions), disassembles it with ``cuobjdump -sass`` and prints one JSON
line per compiled kernel instance whose mangled name holds one of
``--kernels``: its instructions in all, the branches (``BRA``), the
divergent-branch regions (``BSSY``), the global and shared stores and loads,
the shuffles and the MUFU operations, and, when this run built the library,
the registers and spill bytes of nvcc's ``-Xptxas -v`` report
(``chip_smoke.py`` prints those at every build). Imports no jax and nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

COUNTED = ("BRA", "BSSY", "STG", "STS", "LDG", "LDS", "SHFL", "MUFU")


def _root() -> Path:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    return ap.parse_known_args()[0].root.resolve()


def registers(log: str, name: str) -> dict:
    """Registers, stack and spill bytes of ``name`` in nvcc's report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if f"Compiling entry function '{name}'" not in line:
            continue
        rep = {}
        for nxt in lines[i + 1:i + 4]:
            if g := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", nxt):
                rep.update(stack=int(g[1]), spill_stores=int(g[2]), spill_loads=int(g[3]))
            if g := re.search(r"Used (\d+) registers", nxt):
                rep["registers"] = int(g[1])
        return rep
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="the checkout whose package is read")
    ap.add_argument("--kernels", default="ff_pack_kernel,ff_stages_kernel,pack_thresh_kernel",
                    help="comma-separated parts of kernel names")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(_root()))
    from cudacam_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.load()
    sass = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True, text=True,
                          check=True).stdout
    wanted = args.kernels.split(",")
    rows = []
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not any(k in name for k in wanted):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z0-9_]+)", body)
        rows.append(dict(kernel=name, root=str(_root()), instructions=len(ops),
                         **{op: ops.count(op) for op in COUNTED},
                         **registers(lib.compiler_log, name)))
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
