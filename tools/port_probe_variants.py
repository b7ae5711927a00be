#!/usr/bin/env python3
"""Device time of versions of one probe source, each built alone.

Run from the root of a checkout, on a host with a CUDA device and nvcc:

    python3 tools/port_probe_variants.py --swar NAME=SRC [NAME=SRC ...]
    python3 tools/port_probe_variants.py --unpack NAME=SRC [NAME=SRC ...]
    python3 tools/port_probe_variants.py --pack NAME=SRC [NAME=SRC ...]

Each SRC is a version of ``csrc/probe_swar.cu`` (``--swar``) or of
``csrc/probe_hyster.cu`` (``--unpack``, ``--pack``): this checkout's,
another commit's (unpacked with ``git archive``) or an edited copy. nvcc
builds each one alone into its own library (seconds: no other source of
the port), and its C entry point (``cc_swar_stencil``, ``cc_probe_unpack``,
``cc_probe_pack`` with ``ballot=0``) runs on the inputs of
``tools/port_profile.py --parts probes``: K14's four bodies in both modes
at 1080p and 8K, the unpack's two modes on the 8K words, ``probe_pack`` on
the 8K mask, on that mask one byte and four bytes past a 16-byte
boundary, at 1080 x 1920, 1080 x 1918 (rows of every alignment) and at
4320 x 7696. Every
version's output must equal the first's and the plain version's. Then
three rounds, the versions in turns (forward, backward, forward), of
profiler device µs a call (20 calls a session, opened by
``utils.devtime.open_session``; None where the profiler lost records),
one JSON line a (input, version). Imports no jax and nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cudacam_tpu_torch.ops.cuda._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402
from cudacam_tpu_torch.probes import hyster_kernel as hk  # noqa: E402
from cudacam_tpu_torch.probes import i16_swar as sw  # noqa: E402
from cudacam_tpu_torch.utils import devtime  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(versions: dict, entry: str, argtypes: list) -> dict:
    """name -> the entry point of SRC built alone, all versions at once."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, src in versions.items():
        lib = BUILD_DIR / f"variant_{entry}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC_DIR), "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {versions[name]}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and "0 bytes spill stores" not in line})
        print(json.dumps({"version": name, "source": versions[name], "spills": spills}))
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.restype, fn.argtypes = _I, argtypes
        fns[name] = fn
    return fns


def device_us(fn, kernel: str, calls: int = 20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        devtime.open_session()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type.name == "CUDA" and kernel in e.name]
    return sum(us) / calls if len(us) == calls else None


def compare(cases: list, fns: dict, kernel: str, card: str) -> None:
    """cases: (workload, run(fn), output tensor, want). Checks every
    version against ``want``, then times them in turns."""
    for workload, run, out, want in cases:
        for name, fn in fns.items():
            out.zero_()
            if run(fn) != 0:
                raise SystemExit(f"{workload}: version {name} failed to launch")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{workload}: version {name} differs from the plain version")
    times = {}
    order = list(fns.items())
    for rnd in range(3):
        for name, fn in (order if rnd % 2 == 0 else order[::-1]):
            for workload, run, _, _ in cases:
                times.setdefault((workload, name), []).append(
                    device_us(lambda: run(fn), kernel))
    for (workload, name), us in times.items():
        print(json.dumps({"workload": workload, "version": name, "device_us": us, "card": card}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--swar", nargs="*", default=[], help="NAME=SRC versions of probe_swar.cu")
    ap.add_argument("--unpack", nargs="*", default=[], help="NAME=SRC versions of probe_hyster.cu")
    ap.add_argument("--pack", nargs="*", default=[], help="NAME=SRC versions of probe_hyster.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_probe_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream().cuda_stream
    if args.swar:
        fns = build(dict(v.split("=", 1) for v in args.swar), "cc_swar_stencil",
                    [_P, _P, _I, _I, _I, _I, _I, _P])
        cases = []
        for tag, (h, w) in (("1080p", (1080, 1920)), ("8K", (4320, 7680))):
            xi16, xu8 = (torch.from_numpy(a).cuda() for a in sw.probe_inputs(h, w))
            out = torch.empty((h, w), dtype=torch.int32, device="cuda")
            for body in sw.BODIES:
                x = xu8 if body == 4 else xi16
                want = sw.swar_stencil_plain(x, body)
                for swar in (True, False):
                    cases.append((f"swar_stencil P{body} {'SWAR' if swar else 'int32'} {tag}",
                                  lambda fn, x=x, out=out, body=body, swar=swar: fn(
                                      x.data_ptr(), out.data_ptr(), *x.shape, body, int(swar),
                                      0, stream),
                                  out, want))
        compare(cases, fns, "swar_", card)
    if args.unpack:
        fns = build(dict(v.split("=", 1) for v in args.unpack), "cc_probe_unpack",
                    [_P, _P, _I, _I, _I, _I, _P])
        f = torch.from_numpy(hk.unpack_input(2, 4320 // 32, 7680)).cuda()
        out = torch.empty((4320, 7680), dtype=torch.uint8, device="cuda")
        want = hk.probe_unpack_plain(f)
        cases = [(f"probe_unpack {'a thread per word' if pw else 'byte mode'} 135x7680 words",
                  lambda fn, pw=pw: fn(f.data_ptr(), out.data_ptr(), *f.shape, pw, 0, stream),
                  out, want) for pw in (1, 0)]
        compare(cases, fns, "unpack_", card)
        del f, out
    if args.pack:
        fns = build(dict(v.split("=", 1) for v in args.pack), "cc_probe_pack",
                    [_P, _P, _I, _I, _I, _I, _P])
        cases = []
        for tag, (h, w), offset in (("8K mask", (4320, 7680), 0),
                                    ("8K mask one byte off", (4320, 7680), 1),
                                    ("8K mask four bytes off", (4320, 7680), 4),
                                    ("1080x1920 mask", (1080, 1920), 0),
                                    ("1080x1918 mask", (1080, 1918), 0),
                                    ("4320x7696 mask", (4320, 7696), 0)):
            buf = torch.zeros(h * w + 32, dtype=torch.uint8, device="cuda")
            at = -buf.data_ptr() % 16 + offset  # the mask's first byte `offset` past a boundary
            mask = buf[at:at + h * w].view(h, w)
            mask.copy_(torch.from_numpy(hk.pack_input(0, h, w)).cuda())
            out = torch.empty((-(-h // 32), w), dtype=torch.int32, device="cuda")
            cases.append((f"probe_pack {tag}",
                          lambda fn, mask=mask, out=out: fn(mask.data_ptr(), out.data_ptr(),
                                                            *mask.shape, 0, 0, stream),
                          out, hk.probe_pack_plain(mask)))
        compare(cases, fns, "pack_", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
