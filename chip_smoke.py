#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cudacam_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment probe and the card's name and power limit (nvidia-smi);
2. build of the kernels in ``cudacam_tpu_torch/csrc`` with nvcc (sm_90a);
3. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (1080p, 720p) and at 37x53 and 1x1, plus the 1080p spiral
   cut off at the 100-round cap against its recorded digest. Tolerance 0:
   every output is integer, and the contract is byte equality;
4. ``CannyEngine(device='cuda').process`` on eight 1080p scenes and the
   escalating spiral frame, byte-equal to the plain path on the card (and
   seeds 0 and 1 to the NumPy oracle), with every kernel's launch count
   moved; a threshold change changes the output and builds nothing;
5. the steady-state hot path under ``torch.cuda.set_sync_debug_mode("error")``;
6. CUDA-event timings of each kernel and of the 8-frame stream, kernel path
   and plain path.

Any failure raises and exits non-zero before the result line. Without a
CUDA device, or outside a checkout of the repository, it fails at once.
The last line of standard output is the result JSON.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: The 1080p spiral threshold map, max_iters 100, dilate_steps 16,
#: scan_after 12: the output the JAX package's round schedule gives
#: (tests/test_cap_golden.py), so a schedule regression flips it.
SPIRAL_1080P_CAP100_SHA = "61ca860520f82b7a43be20833dcc5858dd7e6d25770f37aa4d9ed3e991848417"
SPIRAL_1080P_CAP100_FINALS = 248514

#: The TPU kernel (pallas_call site) each CUDA kernel replaces.
REPLACES = {
    "ff_pack": "cudacam_tpu/ops/pallas/megakernel.py:569",
    "hyst_phase1": "cudacam_tpu/ops/pallas/megakernel.py:569",
    "hyst_phase2": "cudacam_tpu/ops/pallas/megakernel.py:839",
    "unpack": "cudacam_tpu/ops/pallas/megakernel.py:569",
}
SOURCES = {
    "ff_pack": "cudacam_tpu_torch/csrc/ff_pack.cu",
    "hyst_phase1": "cudacam_tpu_torch/csrc/hyst_rounds.cu",
    "hyst_phase2": "cudacam_tpu_torch/csrc/hyst_rounds.cu",
    "unpack": "cudacam_tpu_torch/csrc/hyst_rounds.cu",
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class Smoke:
    """State shared by the phases: the card, the errors seen per kernel
    and the timings."""

    def __init__(self) -> None:
        import torch

        if not torch.cuda.is_available():
            raise SmokeFailure("no CUDA device: the port's kernels need one")
        try:
            import cudacam_tpu_torch
        except ImportError as e:
            raise SmokeFailure(f"the port is not beside this script: {e}") from e
        pkg = Path(cudacam_tpu_torch.__file__).resolve().parent
        require(pkg == ROOT / "cudacam_tpu_torch", f"imported the port from {pkg}")
        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.err = {name: 0 for name in REPLACES}
        self.ms = {}
        self.plain_ms = {}
        self.launches = {}
        self.card = ""

    # -- helpers -----------------------------------------------------------

    def diff(self, name: str, got, want) -> None:
        """Record |kernel - plain| for ``name`` and fail unless it is 0."""
        torch = self.torch
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        if got.numel():
            d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            self.err[name] = max(self.err[name], d)
        require(self.err[name] == 0, f"{name}: kernel differs from its plain version")

    def time_ms(self, fn, n: int, reps: int = 5, setup=None) -> float:
        """CUDA-event milliseconds per call of ``fn(state)``: ``n`` calls
        back to back in one timed window (states from ``setup()`` made
        before the window), median over ``reps`` windows, after one
        untimed warm-up call."""
        torch = self.torch
        fn(setup() if setup else None)
        per_call = []
        for _ in range(reps):
            states = [setup() if setup else None for _ in range(n)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for state in states:
                fn(state)
            end.record()
            torch.cuda.synchronize()
            per_call.append(start.elapsed_time(end) / n)
        return statistics.median(per_call)

    # -- phases ------------------------------------------------------------

    def phase_env(self) -> None:
        from cudacam_tpu_torch import probe

        print("env:", json.dumps(probe()))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        self.card = smi.stdout.strip().splitlines()[0]
        print(self.card)

    def phase_build(self) -> None:
        from cudacam_tpu_torch.ops.cuda import _build

        lib = _build.load()
        print(f"build: {'built' if lib.built else 'cached'} {lib.path.name} "
              f"in {lib.build_seconds:.2f} s")
        for line in lib.compiler_log.splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas:", line.split("info    :")[-1].strip())

    def phase_kernels(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch.ops import bitpack
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack, ff_pack_plain
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase2, unpack, unpack_plain,
        )
        from cudacam_tpu.io.sources import make_scene, make_spiral_thresh

        thr = torch.tensor([10, 40], dtype=torch.int32, device=self.dev)
        cases = [
            ((1080, 1920), dict()),
            ((720, 1280), dict()),
            ((720, 1280), dict(kernel_size=3, norm="l1")),
            ((720, 1280), dict(kernel_size=7, parity="opencv")),
            ((37, 53), dict()),
            ((1, 1), dict()),
        ]
        for (h, w), kw in cases:
            frame = torch.from_numpy(make_scene(h, w, seed=h + w)).to(self.dev)
            for fr in (frame, frame[..., 1].contiguous()):  # BGR and mono
                f, p = ff_pack(fr, thr, **kw)
                f_ref, p_ref = ff_pack_plain(fr, thr, **kw)
                self.diff("ff_pack", f, f_ref)
                self.diff("ff_pack", p, p_ref)
            # scan_after 64 converges in phase 1; 2 escalates into phase 2.
            for sa in (64, 2):
                rounds = dict(dilate_steps=16, max_iters=100)
                fk, flags = f.clone(), torch.zeros((2, 2), dtype=torch.int32, device=self.dev)
                hyst_phase1(fk, p, flags, h, scan_after=sa, **rounds)
                f1, it, grow = bitpack.converge_phase1(f, p, h, w, scan_after=sa, **rounds)
                self.diff("hyst_phase1", fk, f1)
                self.diff("hyst_phase1", flags[0].cpu(), torch.tensor([it, int(grow)], dtype=torch.int32))
                hyst_phase2(fk, p, flags, h, **rounds)
                if grow:
                    f2, it, grow = bitpack.converge_phase2(f1, p, h, w, it, **rounds)
                else:
                    f2 = f1
                self.diff("hyst_phase2", fk, f2)
                self.diff("hyst_phase2", flags[1].cpu(), torch.tensor([it, int(grow)], dtype=torch.int32))
                self.diff("unpack", unpack(fk, h), unpack_plain(f2, h))
            print(f"kernels == plain at {h}x{w} {kw or 'defaults'}")

        # The cap-truncated spiral: phase 1 to round 12, phase 2 to the cap.
        h, w = 1080, 1920
        f, p = bitpack.pack_pair(torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev))
        flags = torch.zeros((2, 2), dtype=torch.int32, device=self.dev)
        hyst_phase1(f, p, flags, h, dilate_steps=16, scan_after=12, max_iters=100)
        hyst_phase2(f, p, flags, h, dilate_steps=16, max_iters=100)
        out = unpack(f, h).cpu().numpy()
        require(flags.tolist() == [[12, 1], [100, 1]], f"spiral flags {flags.tolist()}")
        finals = int((out == 255).sum())
        sha = hashlib.sha256(out.tobytes()).hexdigest()
        require(finals == SPIRAL_1080P_CAP100_FINALS and sha == SPIRAL_1080P_CAP100_SHA,
                f"spiral cap-100 digest: {finals} finals, sha256 {sha}")
        print(f"spiral 1080p cap 100: {finals} finals, sha256 {sha[:8]}...{sha[-4:]} (recorded)")

    def phase_engine(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyConfig, CannyStage
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.ops import cuda as kernels, torch_ops
        from cudacam_tpu_torch.ops.cuda import _build
        from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline
        from cudacam_tpu.io.sources import make_scene, make_spiral_frame
        from cudacam_tpu.ops import numpy_oracle

        cfg = CannyConfig(height=1080, width=1920)
        eng = CannyEngine(cfg, device="cuda")
        scenes = [make_scene(1080, 1920, seed=s) for s in range(8)]
        spiral = make_spiral_frame(1080, 1920)
        frames = [torch.from_numpy(x).to(self.dev) for x in scenes + [spiral]]
        eng.process(frames[0])  # thresholds to the device before the count
        torch.cuda.synchronize()

        kernels.reset_launch_counts()
        outs = [eng.process(f) for f in frames]
        torch.cuda.synchronize()
        self.launches = kernels.launch_counts()
        require(all(n > 0 for n in self.launches.values()),
                f"a kernel of the main path never launched: {self.launches}")
        print("launches on the main path:", json.dumps(self.launches))

        thr = eng._thresholds()
        for i, (f, out) in enumerate(zip(frames, outs)):
            plain = torch_ops.canny_to_stage(f, thr[0], thr[1], cfg, CannyStage.HYSTER)
            require(torch.equal(out, plain), f"engine frame {i} differs from the plain path")
        for s in (0, 1):
            want = numpy_oracle.canny_pipeline(scenes[s])["hyster"]
            require((outs[s].cpu().numpy() == want).all(), f"seed {s} differs from the oracle")
        _, flags = canny_mega_pipeline(frames[-1], thr, **pipeline_kwargs(cfg))
        require(int(flags[0, 1]) == 1, f"spiral frame did not escalate: {flags.tolist()}")
        print(f"engine == plain on 8 scenes + spiral (flags {flags.tolist()}); seeds 0, 1 == oracle")
        rounds = [canny_mega_pipeline(f, thr, **pipeline_kwargs(cfg))[1].tolist() for f in frames]
        print("flags [[phase-1 rounds, growing], [final rounds, growing]] per frame:", rounds)

        builds = _build.load.cache_info().misses
        eng.set_high_threshold(80)
        eng.set_low_threshold(20)
        out2 = eng.process(frames[0])
        thr2 = eng._thresholds()
        plain2 = torch_ops.canny_to_stage(frames[0], thr2[0], thr2[1], cfg, CannyStage.HYSTER)
        require(torch.equal(out2, plain2), "20/80 output differs from the plain path")
        require(not torch.equal(out2, outs[0]), "threshold change did not change the output")
        require(_build.load.cache_info().misses == builds, "threshold change rebuilt")
        eng.set_low_threshold(10)
        eng.set_high_threshold(40)
        print("threshold 10/40 -> 20/80 changes the output, builds nothing")
        self.eng, self.frames, self.cfg = eng, frames, cfg

    def phase_no_sync(self) -> None:
        torch = self.torch
        eng, frames = self.eng, self.frames[:8]
        eng.process(frames[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for f in frames:
                eng.process(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("steady-state process(): no host sync under set_sync_debug_mode('error')")

    def phase_timing(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyStage
        from cudacam_tpu_torch.ops import bitpack, torch_ops
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack, ff_pack_plain
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase2, unpack, unpack_plain,
        )
        from cudacam_tpu.io.sources import make_spiral_thresh

        eng, cfg, frames = self.eng, self.cfg, self.frames[:8]
        thr = eng._thresholds()
        h, w = 1080, 1920
        rounds = dict(dilate_steps=16, max_iters=100)
        frame = frames[0]
        f0, p0 = ff_pack(frame, thr)
        flags0 = lambda: torch.zeros((2, 2), dtype=torch.int32, device=self.dev)  # noqa: E731

        self.ms["ff_pack"] = self.time_ms(lambda _: ff_pack(frame, thr), 50)
        self.plain_ms["ff_pack"] = self.time_ms(lambda _: ff_pack_plain(frame, thr), 5)
        self.ms["hyst_phase1"] = self.time_ms(
            lambda s: hyst_phase1(s[0], p0, s[1], h, scan_after=64, **rounds), 50,
            setup=lambda: (f0.clone(), flags0()))
        self.plain_ms["hyst_phase1"] = self.time_ms(
            lambda _: bitpack.converge_phase1(f0, p0, h, w, scan_after=64, **rounds), 1, reps=3)
        fs, ps = bitpack.pack_pair(torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev))
        fl = flags0()
        hyst_phase1(fs, ps, fl, h, scan_after=12, **rounds)
        self.ms["hyst_phase2"] = self.time_ms(
            lambda s: hyst_phase2(s[0], ps, s[1], h, **rounds), 3,
            setup=lambda: (fs.clone(), fl.clone()))
        self.plain_ms["hyst_phase2"] = self.time_ms(
            lambda _: bitpack.converge_phase2(fs, ps, h, w, 12, **rounds), 1, reps=1)
        converged = torch.tensor([[3, 0], [0, 0]], dtype=torch.int32, device=self.dev)
        noop_ms = self.time_ms(
            lambda s: hyst_phase2(s[0], p0, s[1], h, **rounds), 50,
            setup=lambda: (f0.clone(), converged.clone()))
        self.ms["unpack"] = self.time_ms(lambda _: unpack(f0, h), 50)
        self.plain_ms["unpack"] = self.time_ms(lambda _: unpack_plain(f0, h), 20)

        def stream(process, reps):
            return self.time_ms(lambda _: [process(f) for f in frames], 1, reps=reps) / len(frames)

        kernel_ms = stream(eng.process, 7)
        plain_ms = stream(lambda f: torch_ops.canny_to_stage(f, thr[0], thr[1], cfg, CannyStage.HYSTER), 5)
        for name in REPLACES:
            print(f"time {name}: kernel {self.ms[name]!r} ms, plain {self.plain_ms[name]!r} ms (1080p)")
        print(f"time hyst_phase2 on a converged frame (returns at once): {noop_ms!r} ms")
        print(f"time 1080p 8-scene stream: kernel path {kernel_ms!r} ms/frame (median of 7 "
              f"passes), plain path {plain_ms!r} ms/frame (median of 5), CUDA events, on {self.card}")

    def result(self) -> None:
        torch = self.torch
        # The JAX package's io.sources and ops.numpy_oracle are jax-free.
        require("jax" not in sys.modules, "jax was imported")
        kernels = [
            {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": self.launches[name],
                "max_abs_err": self.err[name], "ms": self.ms[name],
                "plain_ms": self.plain_ms[name],
            }
            for name in REPLACES
        ]
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,  # the smoke drives cuda:0 only
        }}))


def main() -> int:
    t0 = time.perf_counter()
    try:
        smoke = Smoke()
        for phase in (smoke.phase_env, smoke.phase_build, smoke.phase_kernels,
                      smoke.phase_engine, smoke.phase_no_sync, smoke.phase_timing):
            phase()
            print(f"[{phase.__name__} done at {time.perf_counter() - t0:.1f} s]", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    smoke.result()
    return 0


if __name__ == "__main__":
    sys.exit(main())
