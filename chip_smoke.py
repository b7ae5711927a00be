#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cudacam_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment probe and the card's name and power limit (nvidia-smi);
2. build of the kernels in ``cudacam_tpu_torch/csrc`` with nvcc (sm_90a, one
   nvcc per source, all at once), with nvcc's registers, stack and spill
   bytes of ``ff_pack``'s, ``ff_stages``', ``pack_thresh``', the unpacks',
   the sweep's pack and seed kernels, the round kernels', the exchange's
   and K13's ballot pack and resident loop (each instance);
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes (1080p, 720p), at 37x53 and 1x1 and at the alignment
   classes of ``ff_pack``'s loads and ``unpack``'s row runs (33x1919,
   64x1921, 17x16; both load routes, TMA and cp.async, must be taken):
   ``ff_pack``, the round kernels and ``unpack`` (also indexed, at odd
   widths and heights); ``ff_stages`` for the all-stages set, each stage
   alone and NMSQ, and at 1080p over four configs (kernel sizes 3 / 5 / 7,
   L1 and L2, both parities), gray, the low threshold -3, both load routes
   (1080x1918 BGR and a base one byte off a 16-byte boundary take
   cp.async), three tiles at a global origin and x4 batches in one launch
   against each frame's solo call; ``pack_thresh`` in both modes on each;
   the batched kernels
   against the single-frame ones (8 x 1080p with the escalating spiral,
   3 x 37x53 and 3 x 33x1919, each also as a view one frame in). Then the 1080p spiral cut off at the 100-round cap against
   its recorded digest, through the round kernels and through the
   two-kernel hysteresis (K6), and at the 400-round cap through K6.
   Tolerance 0: every output is integer, and the contract is byte equality;
4. the threshold sweep's kernels (K5) against their plain versions:
   ``sweep_pack_all`` (every slot from one read of keep*g), ``sweep_seed``
   slot by slot at 1080p K=16, 37x53, 33x1919 (rows that are not 16-byte
   aligned) and 8K K=2, with the pack's load route, and the indexed
   ``unpack`` at 1080p K=16;
   whole sweeps (``sweep_fused`` against ``sweep_fused_plain``), both seed
   modes, at 1080p K=16 with ``benchmark.py``'s ``linspace`` pairs, at 720p
   in three configs and at 37x53 with shuffled pairs (negative lows, an
   exact duplicate), converged and cut off by the cap, and at 8K with a K=2
   subset; the 64x128 spiral cut off by the cap against the JAX package's
   finals per pair (seeded [5, 9, 13] and [738, 1410, 2018], cold
   [5, 5, 5] and [738, 738, 738]). Tolerance 0;
5. ``CannyEngine(device='cuda')`` on each path, every launch count set to 0
   just before the path and read just after: ``process`` to HYSTER on eight
   1080p scenes and the spiral (byte-equal to the plain path on the card);
   ``process`` on an 8 x 1080p batch with exactly one escalating frame (four
   launches, equal to eight single-frame calls); ``process`` to every
   display stage (equal to the plain path), and to THRESH on an 8 x 1080p
   batch (one ``ff_stages`` launch, equal to eight single calls);
   ``process_all`` (equal to the
   plain ``torch_ops.canny_all_stages``: integers exactly, grad and slope
   within 1e-6 relative); a threshold change changes the output and builds
   nothing; ``threshold_sweep`` at 1080p K=16 (50 launches, 3K + 2: one
   ``sweep_pack_all``, 15 seeds, 32 round kernels; equal to the
   plain cold sweep ``torch_ops.threshold_sweep``, edge counts falling as
   the thresholds rise). The CPU tests hold the plain path to the NumPy
   oracle and the JAX package; then K6 over a batch: ``pack_thresh`` on an
   x8 1080p stack of threshold maps (seven scenes' and the spiral) against
   its plain version, ``hysteresis_fused_batched`` at caps 2, 12 and 100 on
   1, 3 and 8 of them (4 launches a call) against its plain version and
   against each map's one-map call, ``process_all`` on the x8 batch (5
   launches) against 8 single calls key by key, and their times (CUDA
   events, the profiler's busy time, the wall clock; 8 single
   ``process_all`` calls beside the batched one);
6. the tile-sharded path (``ShardedCannyEngine`` on a one-card mesh): the
   export pack (``ff_pack_export``) and phase 1 (K8), the two refreshes
   (``halo_exchange``), the host loop's round kernels (K9, ``saturate_packed``)
   step by step through the first collective rounds, the one-launch round
   loop (``sharded_loop``, the two refreshes in its prologue) from the
   export's state against the host loop with the plain saturate and refresh,
   at a budget of 0 (the prologue alone) and at the config's (each mesh's
   loop layout printed, and
   the phase-1 and phase-2 rounds of every tile in each collective round the
   step-by-step loop takes), and ``unpack_core`` (K10, with the
   heads and tails its row runs take), each
   against its plain version at each mesh's own tile shapes: 1080p (1, 2, 2)
   (scene + spiral, BGR and mono), 8K (1, 4, 2), 4K x4 (2, 2, 1) and 1080p
   (1, 1, 1); the export pack at tile pitches that are not 16-byte
   aligned (66x1918 over (1, 2, 2), 64x1936 over (1, 1, 2)), with the
   round loop at budgets 0 and 100 and the refresh on the small tiles of the
   first; then, counts set to 0 just before each and read just after
   (four launches a call at caps 100 and 400), HYSTER on one 8K scene over
   (1, 4, 2) and on four 4K scenes over (2, 2, 1) equal to
   ``CannyEngine.process``, on 1080p over (1, 1, 1) equal to it too, the
   1080p spiral over (1, 2, 2) cut off by the cap (100 and 400) equal to the
   plain route on the CPU, rounds included, and THRESH over (1, 2, 2) equal
   to ``CannyEngine.process(frame, THRESH)``; no host sync; the host loop
   on a one-card mesh with an injected local operator (``build_sharded_pipeline
   (local_saturate=)``: K9 as two launches a round, ``halo_exchange`` two
   before the loop and one a round) equal to the one-card loop; then the
   distributed route (the host loop: K9 as two launches a round, the flag
   all-reduced) on a one-process NCCL group, equal to the one-card loop;
7. the steady-state hot paths under ``torch.cuda.set_sync_debug_mode("error")``;
8. CUDA-event timings of each kernel, kernel against plain, with its bound
   (the larger of its bytes over HBM bandwidth and its 32-bit operations
   over the card's peak, counted from this run's inputs and rounds; ``ff_pack``
   also on the 8-scene rotation, where the frame is not still in L2;
   ``ff_stages`` with five outputs, four (gray), THRESH alone, GRADIENT
   alone and NMSQ, ``pack_thresh`` in both modes, each with its own bound), and of
   the streams: single frames, the x8 batch, THRESH and ``process_all``; of
   the K=16 sweeps at 1080p, 4K and 8K (plain at 1080p and 4K, and at 8K
   for K=2), seeded against cold tails at 1080p; of K8, K10, the exchange
   and the round loop at the 8K (1, 4, 2) tiles, of K9 on the 1080p spiral's
   first collective round over (1, 2, 2) (where both of its phases work), of
   the round loop on the 1080p spiral over (1, 2, 2) at caps 100 (cut off)
   and 400 against ``sharded_loop_plain`` (planes, flags, rounds) with its
   bound from the rounds each tile takes and its rounds a collective round,
   and ms/frame of each sharded path beside the unsharded engine and the
   host loop on the same frames;
9. the column-split continuation (K11, ``split_converge``; nvcc's report of
   both ``split_kernel`` instances comes with the build's) against its plain
   version with ``n_split`` 2 and 4 on the 8K spiral's phase-1 exit state
   (cut off by the round budget) and on an 8K scene that escalates and
   converges; ``CannyEngine(continuation='split')`` on the converged 8K
   frame equal to the default engine and on the spiral equal to the plain
   split route, four launches a call whatever the cap, no host sync; its
   time with the seam rounds counted and its layout; the batched call
   (``converge_packed_split_batched``, one launch) against its plain version
   and a call a frame on x8 1080p (7 scenes and the spiral) and x2 8K (scene
   0 and the spiral), with the engine's batch against single calls; the
   engine's launches under ``split`` for B = 1, 2 and 8 (four each); 8K
   ms/frame of ``split`` against ``kernel`` on the cap-class and on a calm
   frame;
10. the legacy row-sweep hysteresis (K12, ``hyst_sweeps``) against its plain
   version at 1080p (scene 0 converged at two block heights; the spiral cut
   off by ``max_iters`` and ``max_local_iters``), equal to the fused
   hysteresis (K6) on converged maps, its ms beside K6's, and its ms and µs
   a promotion step at 1080p, 4K and 8K (scene 0, equal to K6 there);
11. the probes (K13: ``probe_pack``, ``probe_pack_ballot``, ``probe_loop``,
   ``probe_unpack``; K14: ``swar_stencil``): the port's probe tools' runs,
   each kernel against its plain version at the TPU probes' shapes and at
   8K (the packs also at widths 7696, 1918 and 53 and one byte off a
   16-byte boundary, with the ballot pack's grid; the loop on both routes,
   the probe's plane (the tallest resident one) and one word row more, with
   its layout; ``swar_stencil``'s vector route at 256 x 512, 1080p and 8K
   and its general route at 1 x 1, 7 x 9, 3 x 513 and on those three
   planes one element off a 16-byte boundary; the unpack's byte mode at
   the probe's words, 8K, 1 x 1, 2 x 53 and 3 x 513 words and on words one
   word off a boundary; each with its layout and route),
   B/C/D's (326, 0); the cost of one ``grid.sync()`` against the grid
   size, the unpack a thread per word against the byte mode, the four
   stencil bodies in both modes at 1080p, P4 in SWAR against int32 at
   1080p and 8K;
12. the live app (``CannyApp`` on the card): 64 frames of a 1080p BGR
   ``SyntheticSource`` through ``run`` equal to ``CannyEngine.process`` of
   the same frames, the ring holding CUDA tensors; thresholds, a stage cycle
   through all six, pipeline off/on and profiling on/off applied mid-stream
   build nothing; ``profiling_table`` with a time > 0 in every stage's row
   (the card's ``auto`` mode: kernel busy time); a ``BatchSource``
   of 8 through the batched kernels; ``device_health_check``; ms/frame and
   fps of host frames (pinned staging) and of ``preload_device_loop``
   against the bare engine stream; then the native frame pump: a 64-frame
   1080p BGR ``.rawv`` written to a temporary directory, ``CannyApp`` on a
   ``RawvSource`` uploading from the pump's pinned slots, every edge map
   equal to ``CannyEngine.process`` of its frame, and the app's ms/frame
   from the looped file beside the same frames through today's route (a
   list source and the pinned staging copy), with the ``Memcpy HtoD`` µs
   the profiler gives;
13. the benchmark (``python -m cudacam_tpu_torch bench``'s ``main``): the 1080p
   8-scene stream through ``CannyEngine.process``, one JSON line whose metric
   names the ``event`` clock and ``cuda``, printed here (the card's line and
   the kernels' busy time come on standard error), every count set to 0 just
   before and read just after;
14. parity's card route (``parity._our_canny`` on ``device='cuda'``: a cached
   ``CannyEngine``) on ``make_scene`` frames at 288x512 and 540x960, in both
   threshold domains at the parity gate's pairs (10, 40), (20, 60), (30, 90),
   byte-equal (``max_abs_err`` 0) to the CPU route (``torch_ops``). The scores
   need cv2, which the card's host lacks: the CPU tests hold them to the JAX
   package's.

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

#: The 1080p spiral threshold map, dilate_steps 16, scan_after 12, cut off at
#: max_iters 100 and 400: the outputs the JAX package's round schedule gives
#: (tests/test_cap_golden.py), so a schedule regression flips them.
SPIRAL_1080P_CAP100_SHA = "61ca860520f82b7a43be20833dcc5858dd7e6d25770f37aa4d9ed3e991848417"
SPIRAL_1080P_CAP100_FINALS = 248514
SPIRAL_1080P_CAP400_SHA = "a822292e4a2125148907b11f7ca4ed75552e46db4bfa02d196364616b2bfa20d"

#: The 64x128 spiral as a keep*g plane, bounds [1, 2, 1, 2, 0, 2], dilate
#: steps 1: (max_iters, scan_after) -> FINAL pixels per pair, seeded and
#: cold, as the JAX package's sweep_fused gives them (tests/test_torch_sweep.py).
SPIRAL_SWEEP_FINALS = {(4, 100): ([5, 9, 13], [5, 5, 5]),
                       (6, 2): ([738, 1410, 2018], [738, 738, 738])}

#: The TPU kernels (pallas_call sites) each CUDA kernel replaces.
_MEGA = "cudacam_tpu/ops/pallas/megakernel.py"
_FUSED = "cudacam_tpu/ops/pallas/hysteresis_fused.py:365/:373"
_SWEEP = "cudacam_tpu/ops/pallas/hysteresis_fused.py:729"
_EXPORT = f"{_MEGA}:569 via :607"
_SAT = "cudacam_tpu/ops/pallas/hysteresis_fused.py:844"
REPLACES = {
    "ff_pack": f"{_MEGA}:569, {_MEGA}:1109",
    "hyst_phase1": f"{_MEGA}:569, {_MEGA}:1109, {_EXPORT}, {_FUSED}, {_SWEEP}",
    "hyst_phase2": f"{_MEGA}:839, {_FUSED}, {_SWEEP}",
    "unpack": f"{_MEGA}:569, {_MEGA}:1109, {_FUSED}, {_SWEEP}",
    "ff_stages": "cudacam_tpu/ops/pallas/feedforward.py:810",
    "pack_thresh": f"{_FUSED}, via :983 (hysteresis_fused_batched)",
    "sweep_pack_all": _SWEEP,
    "sweep_seed": _SWEEP,
    "ff_pack_export": _EXPORT,
    "saturate_phase1": _SAT,
    "saturate_phase2": _SAT,
    "unpack_core": f"{_MEGA}:714",
    "halo_exchange": "cudacam_tpu/parallel/packed_halo.py:195 (XLA ops, no pallas_call)",
    "sharded_loop": ("cudacam_tpu/parallel/packed_halo.py:256-306 (lax.while_loop: K9 per tile "
                     f"({_SAT}) + the strip exchange + psum)"),
    "split_converge": ("cudacam_tpu/ops/pallas/hysteresis_fused.py:876 (converge_packed_split: "
                       f"{_SAT} per slice + XLA ops) via {_MEGA}:921"),
    "hyst_sweeps": "cudacam_tpu/ops/pallas/hysteresis.py:157",
    "probe_pack": "tools/hyster_kernel_probe.py:42",
    "probe_pack_ballot": "tools/hyster_kernel_probe.py:68",
    "probe_loop": "tools/hyster_kernel_probe.py:114",
    "probe_unpack": "tools/hyster_kernel_probe.py:150",
    "swar_stencil": "tools/i16_swar_probe.py:37",
}
_CSRC = "cudacam_tpu_torch/csrc"
SOURCES = {
    "ff_pack": f"{_CSRC}/ff_pack.cu",
    "hyst_phase1": f"{_CSRC}/hyst_rounds.cu",
    "hyst_phase2": f"{_CSRC}/hyst_rounds.cu",
    "unpack": f"{_CSRC}/unpack.cu",
    "ff_stages": f"{_CSRC}/ff_stages.cu",
    "pack_thresh": f"{_CSRC}/pack.cu",
    "sweep_pack_all": f"{_CSRC}/sweep.cu",
    "sweep_seed": f"{_CSRC}/sweep.cu",
    "ff_pack_export": f"{_CSRC}/ff_pack.cu",
    "saturate_phase1": f"{_CSRC}/hyst_rounds.cu",
    "saturate_phase2": f"{_CSRC}/hyst_rounds.cu",
    "unpack_core": f"{_CSRC}/unpack.cu",
    "halo_exchange": f"{_CSRC}/halo.cu",
    "sharded_loop": f"{_CSRC}/hyst_rounds.cu",
    "split_converge": f"{_CSRC}/hyst_rounds.cu",
    "hyst_sweeps": f"{_CSRC}/hyst_sweep.cu",
    "probe_pack": f"{_CSRC}/probe_hyster.cu",
    "probe_pack_ballot": f"{_CSRC}/probe_hyster.cu",
    "probe_loop": f"{_CSRC}/probe_hyster.cu",
    "probe_unpack": f"{_CSRC}/probe_hyster.cu",
    "swar_stencil": f"{_CSRC}/probe_swar.cu",
}

#: The bound of a timed call: the larger of the bytes it must move (each
#: input read once, each output written once) over HBM's 3.35 TB/s and its
#: 32-bit integer operations over 67 T/s (the published H100 SXM rate of
#: 32-bit arithmetic outside the tensor cores; no table lists int32 apart).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over HBM
    bandwidth and ``ops`` over the 32-bit peak, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
#: Operations per pixel of the stencil chain (mono, Gaussian, Sobel,
#: magnitude, NMS, double threshold): 6 for mono, 2 per Gaussian tap plus the
#: division, 24 for the two Sobel sums, 3 for the squared magnitude, 10 for
#: the NMS sector and compares, 2 for the threshold.
def chain_ops(kernel_size: int) -> int:
    return 6 + 2 * kernel_size * kernel_size + 1 + 24 + 3 + 10 + 2


#: Word operations per packed word of a round: a dilation step (8-neighbour
#: OR with the carries across words, masked by the candidates) 16; the change
#: test 1. A scan direction counts the work an exact scan needs, whatever
#: the algorithm: one (g, p) step a word, an AND and an OR, 2; a diagonal
#: (4-7) adds the one-row shift of the upstream word with its carry across
#: words, 3; a column (2, 3) adds the in-word fill the kernel runs, five
#: doubling steps of 5 operations and the carry in, 27.
DILATE_OPS = 16
SCAN_OPS = 2 * 2 + 4 * (2 + 3) + 2 * (2 + 27)


def round_ops(words: int, dilate_steps: int, scans: bool) -> int:
    """Word operations of one round on ``words`` packed words."""
    return words * (DILATE_OPS * dilate_steps + 1 + (SCAN_OPS if scans else 0))


def refresh_work(g, grid) -> tuple:
    """(bytes, operations) of one halo refresh of the (nb ny nx, hw, ext_w)
    planes of a (nb, ny, nx) mesh of ``g`` tiles: for each pair of
    neighbours, each way, the word rows the sender's 32-row strip spans (or
    its k = min(64, e_left) core lanes over every word row) read once, and
    the word rows the receiver's halo slot spans (or its k halo lanes) read
    and written once (an OR); an OR, two shifts and the mask a word
    written."""
    nb, ny, nx = grid

    def span(b0, b1):  # the word rows of the plane's rows [b0, b1)
        b0, b1 = max(b0, 0), min(b1, g.ext_h)
        return 0 if b1 <= b0 else (b1 - 1) // 32 - b0 // 32 + 1

    top, bot = g.e_top, g.e_top + g.h_loc
    k = min(64, g.e_left)
    v_read = g.ext_w * (span(bot - 32, bot) + span(top, top + 32))
    v_write = g.ext_w * (span(top - 32, top) + span(bot, bot + 32))
    words_r = nb * nx * (ny - 1) * (v_read + v_write) + nb * ny * (nx - 1) * 2 * 2 * k * g.hw
    words_w = nb * nx * (ny - 1) * v_write + nb * ny * (nx - 1) * 2 * k * g.hw
    return 4 * (words_r + words_w), 4 * words_w


def split_work(h: int, w: int, n_split: int, seams, dilate_steps: int) -> tuple:
    """(bytes, operations) of a column-split call whose growing frames took
    the seam rounds ``seams`` (one list of inner rounds a seam round per
    frame): each frame's F and P read once and F written once; each seam
    round a dilation round and then scan rounds on every slice (k + ws + k
    columns, k = min(64, ws)), as many as the slowest slice took."""
    ws = w // n_split
    sw = -(-h // 32) * (ws + 2 * min(64, ws))
    nbytes = 3 * 4 * -(-h // 32) * w * len(seams)
    ops = sum(n_split * (len(s) * round_ops(sw, dilate_steps, False)
                         + (sum(s) - len(s)) * round_ops(sw, dilate_steps, True)) for s in seams)
    return nbytes, ops


#: Word operations per packed word of one promotion step of the row sweeps:
#: three neighbour words ORed, two shifts, two carries, the mask and the test.
SWEEP_STEP_OPS = 12


def core_runs(out, t) -> str:
    """The store route of ``unpack_core`` into the (B, oh, ow) maps ``out``:
    each core row is 16-byte runs, with a head where its first byte is off a
    16-byte boundary and a tail where its end is."""
    b, oh, ow = out.shape
    starts = [out.data_ptr() + (f * oh + r) * ow + j * t.w_loc
              for f in range(b) for r in range(oh) for j in range(t.nx)]
    heads = sum(a % 16 != 0 for a in starts)
    tails = sum((a + t.w_loc) % 16 != 0 for a in starts)
    return (f"route: {len(starts)} core rows of {t.w_loc} bytes in 16-byte vector runs, "
            f"{heads} with a head, {tails} with a tail")


def sweep_pairs():
    """``benchmark.py``'s K=16 sweep: lows 5..60, highs 20..180."""
    import numpy as np

    return np.linspace(5, 60, 16).astype(np.int32), np.linspace(20, 180, 16).astype(np.int32)


#: Shuffled pairs: negative lows (-1 and -3 clamp to a 0 bound), an exact
#: duplicate (20, 60), a pair that dominates nothing before it.
SHUFFLED_LOWS = [20, -1, 5, -3, 20, 10, 40]
SHUFFLED_HIGHS = [60, 40, 40, 30, 60, 25, 254]


def plain_sweep(frame, lows, highs, cfg):
    """The sweep's plain version, on the frame's device: ``ff_stages_plain``'s
    keep*g plane, the bounds, ``sweep_fused_plain`` with the monotone seed."""
    from cudacam_tpu_torch.ops.cuda.canny import ff_kwargs, hyster_kwargs, sweep_bounds
    from cudacam_tpu_torch.ops.cuda.feedforward import NMSQ, ff_stages_plain
    from cudacam_tpu_torch.ops.cuda.hysteresis_fused import sweep_fused_plain

    (kg,) = ff_stages_plain(frame, None, (NMSQ,), **ff_kwargs(cfg))
    return sweep_fused_plain(kg, sweep_bounds(lows, highs, cfg), **hyster_kwargs(cfg))


def kernel_reports(log: str, names):
    """(kernel entry, {registers, stack, spill_stores, spill_loads}) from
    nvcc's ``-Xptxas -v`` report, for each compiled entry whose mangled name
    holds one of ``names`` (each template instance apart)."""
    import re

    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m or not any(n in m.group(1) for n in names):
            continue
        rep = {}
        for nxt in lines[i + 1:i + 4]:
            if g := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", nxt):
                rep.update(stack=int(g[1]), spill_stores=int(g[2]), spill_loads=int(g[3]))
            if g := re.search(r"Used (\d+) registers", nxt):
                rep["registers"] = int(g[1])
        yield m.group(1), rep


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class Smoke:
    """State shared by the phases: the card, the errors seen per kernel,
    the launch counts per path and the timings."""

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
        self.launches = {name: 0 for name in REPLACES}
        self.bound = {}  # name -> (ms, "bytes" | "operations")
        self.library_ms = {}  # name -> ms of one PyTorch call computing the same function
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

    def path(self, name: str, run, expect) -> object:
        """Drive one path with every launch count set to 0 just before and
        read just after; ``expect`` maps each kernel the path must launch to
        its count."""
        from cudacam_tpu_torch.ops import cuda as kernels

        self.torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = run()
        self.torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k, n in expect.items():
            require(counts[k] == n, f"path {name}: {k} launched {counts[k]} times, expected {n}")
        for k, n in counts.items():
            self.launches[k] += n
        print(f"launches on path '{name}':", json.dumps({k: n for k, n in counts.items() if n}))
        return out

    def set_bound(self, name: str, nbytes: float, ops: float) -> None:
        """The least time the card could take for the timed call of
        ``name`` (:func:`bound_ms`)."""
        self.bound[name] = bound_ms(nbytes, ops)

    def wall_ms(self, run, n: int) -> float:
        """Wall-clock ms per frame of ``run()`` over ``n`` frames, from an
        idle card to the last frame's end."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

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
        for name, rep in kernel_reports(lib.compiler_log, (
                "ff_pack_kernel", "ff_stages_kernel", "pack_thresh_kernel", "unpack_kernel",
                "unpack_core_kernel", "sweep_pack_all_kernel", "sweep_seed_kernel",
                "hyst_kernel", "split_kernel", "sharded_loop_kernel", "exchange_kernel",
                "pack_ballot_kernel", "loop_block_kernel", "pack_tile_kernel")):
            print(f"nvcc report {name}: {json.dumps(rep)}")

    def phase_kernels(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch.ops import bitpack
        from cudacam_tpu_torch.ops.cuda.feedforward import (
            FF_STAGES, NMSQ, ff_pack, ff_pack_plain, ff_stages, ff_stages_plain, load_route,
        )
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            hysteresis_fused, pack_thresh, pack_thresh_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase2, unpack, unpack_plain,
        )
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_thresh

        thr = torch.tensor([10, 40], dtype=torch.int32, device=self.dev)
        cases = [
            ((1080, 1920), dict()),
            ((720, 1280), dict()),
            ((720, 1280), dict(kernel_size=3, norm="l1")),
            ((720, 1280), dict(kernel_size=7, parity="opencv")),
            ((37, 53), dict()),
            ((1, 1), dict()),
            # Alignment classes of ff_pack's loads: rows of 5757 / 5763 /
            # 48 bytes (cp.async chunks for the BGR frames; mono rows of 16
            # bytes take TMA).
            ((33, 1919), dict()),
            ((64, 1921), dict(kernel_size=3, norm="l1")),
            ((17, 16), dict(kernel_size=7, parity="opencv")),
        ]
        stage_sets = [FF_STAGES, (NMSQ,)] + [(s,) for s in FF_STAGES]
        routes = {}
        for (h, w), kw in cases:
            frame = torch.from_numpy(make_scene(h, w, seed=h + w)).to(self.dev)
            for fr in (frame, frame[..., 1].contiguous()):  # BGR and mono
                routes.setdefault(load_route(fr), []).append(f"{h}x{w}{'' if fr.ndim == 3 else ' mono'}")
                f, p = ff_pack(fr, thr, **kw)
                f_ref, p_ref = ff_pack_plain(fr, thr, **kw)
                self.diff("ff_pack", f, f_ref)
                self.diff("ff_pack", p, p_ref)
                for stages in stage_sets:
                    got = ff_stages(fr, thr, stages, **kw)
                    for g, e in zip(got, ff_stages_plain(fr, thr, stages, **kw)):
                        self.diff("ff_stages", g, e)
                (thresh,) = ff_stages(fr, thr, (FF_STAGES[-1],), **kw)
                (kg,) = ff_stages(fr, None, (NMSQ,), **kw)
                for got, want in ((pack_thresh(thresh), pack_thresh_plain(thresh)),
                                  (pack_thresh(kg, thr * thr), pack_thresh_plain(kg, thr * thr))):
                    self.diff("pack_thresh", got[0], want[0])
                    self.diff("pack_thresh", got[1], want[1])
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
        require(set(routes) == {"tma", "cp.async"}, f"ff_pack load routes {routes}")
        print(f"ff_pack load routes taken: {json.dumps(routes)}")
        self.stage_walk()
        # Unpack at odd widths and heights: heads and tails of the row runs.
        for h, w, n in ((33, 1919, 3), (17, 16, 2), (1, 70, 1), (64, 1921, 2), (31, 1, 1)):
            fw = torch.randint(-2**31, 2**31 - 1, (n, -(-h // 32), w), dtype=torch.int32,
                               device=self.dev)
            index = torch.randperm(n, device=self.dev).to(torch.int32)
            self.diff("unpack", unpack(fw, h), unpack_plain(fw, h))
            self.diff("unpack", unpack(fw, h, index), unpack_plain(fw, h, index))
            self.diff("unpack", unpack(fw[-1], h), unpack_plain(fw[-1], h))
        print("unpack == plain at 33x1919 x3, 17x16 x2, 1x70, 64x1921 x2, 31x1, indexed too")

        self.batched_vs_single()

        # The cap-truncated spiral: phase 1 to round 12, phase 2 to the cap,
        # through the round kernels and through K6 (pack_thresh + the same).
        h, w = 1080, 1920
        spiral_t = torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev)
        f, p = bitpack.pack_pair(spiral_t)
        flags = torch.zeros((2, 2), dtype=torch.int32, device=self.dev)
        hyst_phase1(f, p, flags, h, dilate_steps=16, scan_after=12, max_iters=100)
        hyst_phase2(f, p, flags, h, dilate_steps=16, max_iters=100)
        out = unpack(f, h)
        require(flags.tolist() == [[12, 1], [100, 1]], f"spiral flags {flags.tolist()}")
        for cap, want_sha in ((100, SPIRAL_1080P_CAP100_SHA), (400, SPIRAL_1080P_CAP400_SHA)):
            k6, iters = hysteresis_fused(spiral_t, max_iters=cap, dilate_steps=16,
                                         scan_after=12, return_iters=True)
            outs = [("K6", k6.cpu().numpy())] + ([("rounds", out.cpu().numpy())] if cap == 100 else [])
            for route, o in outs:
                finals = int((o == 255).sum())
                sha = hashlib.sha256(o.tobytes()).hexdigest()
                require(sha == want_sha and (cap != 100 or finals == SPIRAL_1080P_CAP100_FINALS),
                        f"spiral cap-{cap} digest through {route}: {finals} finals, sha256 {sha}")
                print(f"spiral 1080p cap {cap} through {route}: {finals} finals, "
                      f"sha256 {sha[:8]}...{sha[-4:]} (recorded)")
            require(int(iters) == cap, f"K6 spiral cap {cap}: {int(iters)} rounds")
        self.tall_planes()

    def stage_walk(self) -> None:
        """``ff_stages`` and ``pack_thresh`` at 1080p over the card tests'
        spread: both load routes (BGR 1080x1918 and a copy of the 1080p
        frame whose base is one byte past a 16-byte boundary take cp.async),
        kernel sizes 3 / 5 / 7, L1 and L2, both parities, gray, the low
        threshold -3; tiles at a global origin of the 1080p image; a batch
        of four frames in one launch against each frame's solo call."""
        torch = self.torch
        from cudacam_tpu_torch import CannyStage
        from cudacam_tpu_torch.ops.cuda.feedforward import (
            FF_STAGES, NMSQ, ff_stages, ff_stages_batched, ff_stages_plain, load_route,
        )
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import pack_thresh, pack_thresh_plain
        from cudacam_tpu_torch.io.sources import make_scene

        def unaligned(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            out = buf[1:].view(x.shape)
            out.copy_(x)
            return out

        def same(name, got, want):
            for g, e in zip(got, want):
                self.diff(name, g, e)

        frame = torch.from_numpy(make_scene(1080, 1920, seed=3)).to(self.dev)
        inputs = [frame, frame[..., 1].contiguous(), unaligned(frame),
                  torch.from_numpy(make_scene(1080, 1918, seed=4)).to(self.dev)]
        configs = [dict(), dict(kernel_size=3, norm="l1"),
                   dict(kernel_size=7, parity="opencv", grad_coeff=2),
                   dict(kernel_size=5, norm="l1", parity="opencv")]
        sets = [FF_STAGES, (NMSQ,), (CannyStage.GRADIENT,), (CannyStage.MONO,)]
        routes = {}
        for x in inputs:
            routes.setdefault(load_route(x), []).append(f"{tuple(x.shape)}")
            for kw in configs:
                for lo, hi in ((10, 40), (-3, 300)):
                    thr = torch.tensor([lo, hi], dtype=torch.int32, device=self.dev)
                    for stages in sets:
                        same("ff_stages", ff_stages(x, thr, stages, **kw),
                             ff_stages_plain(x, thr, stages, **kw))
                    (tmap,) = ff_stages(x, thr, (CannyStage.THRESH,), **kw)
                    (kg,) = ff_stages(x, None, (NMSQ,), **kw)
                    same("pack_thresh", pack_thresh(tmap), pack_thresh_plain(tmap))
                    same("pack_thresh", pack_thresh(unaligned(tmap)), pack_thresh_plain(tmap))
                    same("pack_thresh", pack_thresh(kg, thr * thr), pack_thresh_plain(kg, thr * thr))
        require(set(routes) == {"tma", "cp.async"}, f"ff_stages load routes {routes}")
        thr = torch.tensor([10, 40], dtype=torch.int32, device=self.dev)
        for (oy, ox), (th, tw) in (((-4, -4), (548, 968)), ((536, 956), (548, 968)),
                                   ((-4, 1000), (300, 925))):
            tile = torch.zeros((th, tw, 3), dtype=torch.uint8, device=self.dev)
            y0, x0 = max(oy, 0), max(ox, 0)
            y1, x1 = min(oy + th, 1080), min(ox + tw, 1920)
            tile[y0 - oy:y1 - oy, x0 - ox:x1 - ox] = frame[y0:y1, x0:x1]
            for x in (tile, tile[..., 0].contiguous(), unaligned(tile)):
                for stages in (FF_STAGES, (NMSQ,), (CannyStage.GRADIENT,)):
                    geo = dict(origin=(oy, ox), image_size=(1080, 1920))
                    same("ff_stages", ff_stages(x, thr, stages, **geo),
                         ff_stages_plain(x, thr, stages, **geo))
        batch = torch.stack([torch.from_numpy(make_scene(1080, 1920, seed=s)).to(self.dev)
                             for s in range(4)])
        for x in (batch, batch[..., 2].contiguous(), batch[1:]):
            for stages in (FF_STAGES, (NMSQ,)):
                got = ff_stages_batched(x, thr, stages)
                for b in range(len(x)):
                    same("ff_stages", [g[b] for g in got], ff_stages(x[b], thr, stages))
                    same("ff_stages", [g[b] for g in got], ff_stages_plain(x[b], thr, stages))
        print(f"ff_stages == plain at 1080p over 4 configs, lo 10 and -3, on both load routes "
              f"({json.dumps(routes)}), at three tiles of a global origin, and x4 batches (one "
              f"launch) == each frame's solo call; pack_thresh == plain in both modes on each")

    def tall_planes(self) -> None:
        """Planes taller than one band a block's shared memory holds (476
        word rows in phase 2, 785 in phase 1): the round kernels cut them
        into stacked height segments; both phases on the spiral, cut off by
        the cap, against plain."""
        torch = self.torch
        from cudacam_tpu_torch.ops import bitpack
        from cudacam_tpu_torch.ops.cuda.megakernel import hyst_phase1, hyst_phase2, round_layout
        from cudacam_tpu_torch.io.sources import make_spiral_thresh

        rounds = dict(dilate_steps=16, max_iters=30)
        for h, w in ((16000, 1920), (26000, 257)):
            lay = [round_layout(1, h, w, 16, phase) for phase in (1, 2)]
            require(lay[1]["segments"] > 1 and (h == 16000 or lay[0]["segments"] > 1),
                    f"{h}x{w}: layouts {lay}")
            f, p = bitpack.pack_pair(torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev))
            fk, flags = f.clone(), torch.zeros((2, 2), dtype=torch.int32, device=self.dev)
            hyst_phase1(fk, p, flags, h, scan_after=2, **rounds)
            f1, it, grow = bitpack.converge_phase1(f, p, h, w, scan_after=2, **rounds)
            self.diff("hyst_phase1", fk, f1)
            self.diff("hyst_phase1", flags[0].cpu(), torch.tensor([it, int(grow)], dtype=torch.int32))
            hyst_phase2(fk, p, flags, h, **rounds)
            f2, it, grow = bitpack.converge_phase2(f1, p, h, w, it, **rounds) if grow else (f1, it, grow)
            self.diff("hyst_phase2", fk, f2)
            self.diff("hyst_phase2", flags[1].cpu(), torch.tensor([it, int(grow)], dtype=torch.int32))
            print(f"kernels == plain on the tall {h}x{w} spiral, flags {flags.tolist()}, "
                  f"layouts {json.dumps(lay)}")

    def batched_vs_single(self) -> None:
        """The batched kernels (one launch for the batch) against the
        single-frame kernels, frame by frame, on batches whose frames stop
        at different rounds."""
        torch = self.torch
        import numpy as np
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack, ff_pack_batched
        from cudacam_tpu_torch.ops.cuda.megakernel import hyst_phase1, hyst_phase2, unpack
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame

        thr = torch.tensor([10, 40], dtype=torch.int32, device=self.dev)
        rounds = dict(dilate_steps=16, max_iters=100)
        for h, w, n, sa in ((1080, 1920, 8, 12), (37, 53, 3, 2), (33, 1919, 3, 2)):
            frames = [make_scene(h, w, seed=s) for s in range(n - 1)] + [make_spiral_frame(h, w)]
            batch = torch.from_numpy(np.stack(frames)).to(self.dev)
            # The last: frames 1.. of the batch, a view whose base is one frame in.
            for x in (batch, batch[..., 0].contiguous(), batch[1:]):
                f, p = ff_pack_batched(x, thr)
                f_packed = f.clone()
                flags = torch.zeros((len(x), 2, 2), dtype=torch.int32, device=self.dev)
                hyst_phase1(f, p, flags, h, scan_after=sa, **rounds)
                hyst_phase2(f, p, flags, h, **rounds)
                edges = unpack(f, h)
                for b in range(len(x)):
                    f1, p1 = ff_pack(x[b], thr)
                    self.diff("ff_pack", f_packed[b], f1)
                    self.diff("ff_pack", p[b], p1)
                    fl1 = torch.zeros((2, 2), dtype=torch.int32, device=self.dev)
                    hyst_phase1(f1, p1, fl1, h, scan_after=sa, **rounds)
                    self.diff("hyst_phase1", flags[b, 0], fl1[0])
                    hyst_phase2(f1, p1, fl1, h, **rounds)
                    self.diff("hyst_phase2", f[b], f1)
                    self.diff("hyst_phase2", flags[b], fl1)
                    self.diff("unpack", edges[b], unpack(f1, h))
            grown = [int(v) for v in flags[:, 0, 1].tolist()]
            print(f"batched == single-frame kernels at {n} x {h}x{w}, BGR, mono and frames "
                  f"1.. (growing at scan_after {sa}, frames 1..: {grown})")

    def phase_sweep(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyConfig
        from cudacam_tpu_torch.ops.cuda.canny import ff_kwargs, hyster_kwargs, sweep_bounds
        from cudacam_tpu_torch.ops.cuda.feedforward import NMSQ, ff_stages
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            sweep_fused, sweep_fused_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import unpack, unpack_plain
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_thresh

        lows16, highs16 = sweep_pairs()
        shuffled = (SHUFFLED_LOWS, SHUFFLED_HIGHS)
        cases = [  # (h, w), config, (lows, highs), extra round settings
            ((1080, 1920), dict(), (lows16, highs16), []),
            ((720, 1280), dict(), shuffled, [(2, 5)]),
            ((720, 1280), dict(kernel_size=3, norm="l1"), shuffled, [(2, 5)]),
            ((720, 1280), dict(kernel_size=7, parity="opencv"), shuffled, [(2, 5)]),
            ((37, 53), dict(), shuffled, [(2, 5), (3, 3)]),
            ((4320, 7680), dict(), (lows16[[0, -1]], highs16[[0, -1]]), []),
        ]
        for (h, w), kw, (lows, highs), extra in cases:
            cfg = CannyConfig(height=h, width=w, **kw)
            frame = torch.from_numpy(make_scene(h, w, seed=h + w)).to(self.dev)
            (kg,) = ff_stages(frame, None, (NMSQ,), **ff_kwargs(cfg))
            bounds = sweep_bounds(torch.tensor(lows, dtype=torch.int32, device=self.dev),
                                  torch.tensor(highs, dtype=torch.int32, device=self.dev), cfg)
            rounds = [hyster_kwargs(cfg)] + [
                dict(hyster_kwargs(cfg), scan_after=sa, max_iters=mi) for sa, mi in extra]
            finals = {}
            for rkw in rounds:
                for seed in (True, False):
                    got = sweep_fused(kg, bounds, monotone_seed=seed, **rkw)
                    self.sweep_diff(got, sweep_fused_plain(kg, bounds, monotone_seed=seed, **rkw),
                                    seed)
                    finals[(rkw["scan_after"], rkw["max_iters"], seed)] = (
                        (got == 255).sum((1, 2)).tolist())
            print(f"sweep_fused == plain at {h}x{w} {kw or 'defaults'}, K={len(lows)}, both seed "
                  f"modes; finals per pair: {finals}")
            if h in (1080, 37, 4320):
                self.sweep_packs(kg, bounds)
            if h == 1080:
                f = torch.randint(-2**31, 2**31 - 1, (16, -(-h // 32), w), dtype=torch.int32,
                                  device=self.dev)
                index = torch.randperm(16, device=self.dev).to(torch.int32)
                self.diff("unpack", unpack(f, h, index), unpack_plain(f, h, index))

        # Rows of 1919 int32 values: no row but the first starts 16-byte aligned.
        self.sweep_packs(torch.randint(-100, 3000, (33, 1919), dtype=torch.int32, device=self.dev),
                         torch.tensor([900, 2000, 900, 2000, -4, 2500, 100, 400, 0, 0],
                                      dtype=torch.int32, device=self.dev))

        # The spiral cut off by the cap: the JAX package's finals per pair.
        t = torch.from_numpy(make_spiral_thresh(64, 128)).to(self.dev)
        kg = torch.where(t == 255, 3, torch.where(t == 128, 2, 0)).to(torch.int32)
        bounds = torch.tensor([1, 2, 1, 2, 0, 2], dtype=torch.int32, device=self.dev)
        for (max_iters, scan_after), want in SPIRAL_SWEEP_FINALS.items():
            rkw = dict(max_iters=max_iters, scan_after=scan_after, dilate_steps=1)
            for seed, finals in zip((True, False), want):
                got = sweep_fused(kg, bounds, monotone_seed=seed, **rkw)
                self.sweep_diff(got, sweep_fused_plain(kg, bounds, monotone_seed=seed, **rkw), seed)
                n = (got == 255).sum((1, 2)).tolist()
                require(n == finals, f"spiral sweep {rkw} seed {seed}: finals {n}, want {finals}")
        print(f"spiral 64x128 sweep cut off by the cap == JAX finals {SPIRAL_SWEEP_FINALS}")

    def sweep_diff(self, got, want, seeded: bool) -> None:
        """A whole sweep against its plain version: the pack's, and with
        the monotone seed also the seed step's."""
        self.diff("sweep_pack_all", got, want)
        if seeded:
            self.diff("sweep_seed", got, want)

    def sweep_packs(self, kg, bounds) -> None:
        """``sweep_pack_all`` (one launch for every slot) over planes that
        held other words, and ``sweep_seed`` slot by slot on the same prior
        planes, each against its plain version; with the pack's load
        route."""
        torch = self.torch
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            sweep_pack_all, sweep_pack_all_plain, sweep_seed, sweep_seed_plain,
        )

        k, (h, w) = bounds.numel() // 2, kg.shape
        shape = (k, -(-h // 32), w)
        f0 = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=self.dev)
        p0 = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=self.dev)
        f, p, fp, pp = f0.clone(), p0.clone(), f0.clone(), p0.clone()
        sweep_pack_all(kg, bounds, f, p)
        sweep_pack_all_plain(kg, bounds, fp, pp)
        self.diff("sweep_pack_all", f, fp)
        self.diff("sweep_pack_all", p, pp)
        for slot in range(1, k):
            f, fp = f0.clone(), f0.clone()
            sweep_seed(bounds, slot, f)
            sweep_seed_plain(bounds, slot, fp)
            self.diff("sweep_seed", f, fp)
        print(f"sweep_pack_all == plain at {h}x{w}, K={k} (route: one launch of "
              f"{-(-w // 256)} x {shape[1]} blocks, a thread per column of a word row, 32 "
              f"4-byte loads a thread, 128 contiguous bytes a warp a row, rows "
              f"{'' if (4 * w) % 16 == 0 else 'not '}16-byte aligned; keep*g read once); "
              f"sweep_seed == plain at slots 1..{k - 1}")

    def phase_engine(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyConfig, CannyStage
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.ops import torch_ops
        from cudacam_tpu_torch.ops.cuda import _build
        from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            canny_mega_pipeline, canny_mega_pipeline_batched,
        )
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame

        cfg = CannyConfig(height=1080, width=1920)
        eng = CannyEngine(cfg, device="cuda")
        scenes = [make_scene(1080, 1920, seed=s) for s in range(8)]
        spiral = make_spiral_frame(1080, 1920)
        frames = [torch.from_numpy(x).to(self.dev) for x in scenes + [spiral]]
        eng.process(frames[0])  # thresholds to the device before the count
        thr = eng._thresholds()
        main = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack")

        outs = self.path("process HYSTER, 9 frames", lambda: [eng.process(f) for f in frames],
                         dict.fromkeys(main, len(frames)))
        for i, (f, out) in enumerate(zip(frames, outs)):
            plain = torch_ops.canny_to_stage(f, thr[0], thr[1], cfg, CannyStage.HYSTER)
            require(torch.equal(out, plain), f"engine frame {i} differs from the plain path")
        _, flags = canny_mega_pipeline(frames[-1], thr, **pipeline_kwargs(cfg))
        require(int(flags[0, 1]) == 1, f"spiral frame did not escalate: {flags.tolist()}")
        print(f"engine == plain on 8 scenes + spiral (flags {flags.tolist()})")
        rounds = [canny_mega_pipeline(f, thr, **pipeline_kwargs(cfg))[1].tolist() for f in frames]
        print("flags [[phase-1 rounds, growing], [final rounds, growing]] per frame:", rounds)

        # x8 batch: seven scenes and the spiral, four launches in all.
        batch = torch.stack(frames[:7] + frames[-1:])
        bout = self.path("process HYSTER, 8 x 1080p batch", lambda: eng.process(batch),
                         dict.fromkeys(main, 1))
        for i in range(8):
            require(torch.equal(bout[i], eng.process(batch[i])),
                    f"batch frame {i} differs from its single-frame process")
        _, bflags = canny_mega_pipeline_batched(batch, thr, **pipeline_kwargs(cfg))
        grown = bflags[:, 0, 1].tolist()
        require(grown == [0] * 7 + [1], f"batch escalation flags {bflags.tolist()}")
        print(f"batch == 8 single-frame calls; only the spiral escalated: {bflags.tolist()}")

        display = [s for s in CannyStage if s != CannyStage.HYSTER]
        souts = self.path("process MONO..THRESH",
                          lambda: [eng.process(frames[0], s) for s in display],
                          {"ff_stages": len(display)})
        for seed in (0, 1):
            got = souts if seed == 0 else [eng.process(frames[1], s) for s in display]
            for s, g in zip(display, got):
                plain = torch_ops.canny_to_stage(frames[seed], thr[0], thr[1], cfg, s)
                require(torch.equal(g, plain), f"stage {s.name} seed {seed} differs from plain")
        print("every display stage == plain path, seeds 0 and 1")

        tbatch = torch.stack(frames[:8])
        tout = self.path("process THRESH, 8 x 1080p batch",
                         lambda: eng.process(tbatch, CannyStage.THRESH), {"ff_stages": 1})
        for i in range(8):
            require(torch.equal(tout[i], souts[-1] if i == 0 else
                                eng.process(tbatch[i], CannyStage.THRESH)),
                    f"THRESH batch frame {i} differs from its single-frame process")
        print("process THRESH on an 8 x 1080p batch: one ff_stages launch, == 8 single calls")

        allk = self.path("process_all", lambda: eng.process_all(frames[-1]),
                         dict(ff_stages=1, pack_thresh=1, hyst_phase1=1, hyst_phase2=1, unpack=1))
        want = torch_ops.canny_all_stages(frames[-1], thr[0], thr[1], cfg)
        require(allk.keys() == want.keys(), f"process_all keys {sorted(allk)}")
        for k, e in want.items():
            g = allk[k]
            require(g.dtype == e.dtype and g.shape == e.shape, f"process_all {k}: {g.dtype}")
            if k in ("grad", "slope"):
                require(bool(torch.allclose(g, e, rtol=1e-6, atol=0)), f"process_all {k} not within 1e-6")
            else:
                require(torch.equal(g, e), f"process_all {k} differs from the plain path")
        require(torch.equal(allk["hyster"], outs[-1]), "process_all edge map != process HYSTER")
        print("process_all == torch_ops.canny_all_stages on the spiral frame (10 keys)")

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

        # The threshold sweep: K=16 pairs over scene 0, 50 launches.
        lows, highs = sweep_pairs()
        k = len(lows)
        maps, counts = self.path(
            "threshold_sweep, 1080p K=16", lambda: eng.threshold_sweep(frames[0], lows, highs),
            dict(ff_pack=0, pack_thresh=0, ff_stages=1, sweep_pack_all=1, sweep_seed=k - 1,
                 hyst_phase1=k, hyst_phase2=k, unpack=1))
        require(maps.shape == (k, 1080, 1920) and maps.dtype == torch.uint8
                and counts.shape == (k,) and counts.dtype == torch.int32,
                f"sweep result {tuple(maps.shape)} {maps.dtype}, {tuple(counts.shape)} {counts.dtype}")
        plain_maps, plain_counts = torch_ops.threshold_sweep(
            frames[0], torch.from_numpy(lows).to(self.dev), torch.from_numpy(highs).to(self.dev),
            cfg)
        require(torch.equal(maps, plain_maps) and torch.equal(counts, plain_counts),
                "threshold_sweep differs from the plain cold sweep")
        n = counts.tolist()
        require(n == sorted(n, reverse=True) and n[0] > n[-1] > 0, f"sweep edge counts {n}")
        print(f"threshold_sweep 1080p K=16 == plain cold sweep; edge counts {n}")
        self.eng, self.frames, self.cfg, self.batch = eng, frames, cfg, batch

    def phase_batched_hysteresis(self) -> None:
        """K6 over a batch (``hysteresis_fused_batched``) and ``process_all``
        on a batch through it, at x8 1080p."""
        torch = self.torch
        from cudacam_tpu_torch import CannyStage
        from cudacam_tpu_torch.ops.cuda import hysteresis_fused_batched, hysteresis_fused_batched_plain
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            hysteresis_fused, pack_thresh, pack_thresh_plain,
        )
        from cudacam_tpu_torch.io.sources import make_spiral_thresh

        eng, h, w = self.eng, 1080, 1920
        # Seven scenes' threshold maps and the spiral map: mixed depths.
        maps = [eng.process(f, CannyStage.THRESH) for f in self.frames[:7]]
        maps.append(torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev))
        stack = torch.stack(maps)
        got, want = pack_thresh(stack), pack_thresh_plain(stack)
        self.diff("pack_thresh", got[0], want[0])
        self.diff("pack_thresh", got[1], want[1])
        print("pack_thresh on an x8 1080p stack (7 scenes' maps + the spiral) == plain, one launch")
        four = dict(pack_thresh=1, hyst_phase1=1, hyst_phase2=1, unpack=1)
        for cap, scan_after in ((2, 1), (12, 10), (100, 64)):
            kw = dict(max_iters=cap, dilate_steps=16, scan_after=scan_after)
            for g in (1, 3, 8):
                out = self.path(f"hysteresis_fused_batched, {g} x 1080p, cap {cap}",
                                lambda: hysteresis_fused_batched(stack[:g], **kw), four)
                plain = hysteresis_fused_batched_plain(stack[:g], **kw)
                for name in four:
                    self.diff(name, out, plain)
                for i in range(g):
                    self.diff("pack_thresh", out[i], hysteresis_fused(stack[i], **kw))
            finals = (out == 255).sum((1, 2)).tolist()
            print(f"hysteresis_fused_batched cap {cap} (scan_after {scan_after}) at g = 1, 3, 8: "
                  f"4 launches a call, == plain and == 8 one-map calls (max_abs_err 0); "
                  f"FINAL pixels per map at g = 8: {finals}")

        batch = self.batch  # 7 scenes + the spiral frame
        five = dict(ff_stages=1, **four)
        allb = self.path("process_all, 8 x 1080p batch", lambda: eng.process_all(batch), five)
        for i in range(len(batch)):
            one = eng.process_all(batch[i])
            for k, e in one.items():
                g = allb[k][i]
                require(g.dtype == e.dtype and torch.equal(g, e),
                        f"process_all batch frame {i} key {k} differs from its single call")
        print("process_all on the x8 batch (7 scenes + spiral): 5 launches, every key == "
              "8 single calls")
        self.k6_stack = stack

    def phase_batched_timing(self) -> None:
        """Times of the batched K6 call and its pack (events, the profiler's
        busy time, plain, bound) and of ``process_all`` on an x8 batch
        against 8 single calls in the same process. Before the sharded
        phases, so that the app phase's device-mode table, minutes later,
        meets the profiler's loss of a session's first records
        (``utils.devtime.SENTINELS``; ROADMAP Queue 3, F8)."""
        torch = self.torch
        from cudacam_tpu_torch.ops.cuda import hysteresis_fused_batched, hysteresis_fused_batched_plain
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import pack_thresh, pack_thresh_plain
        from cudacam_tpu_torch.ops.cuda.megakernel import converge
        from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call

        eng, stack, batch, h, w = self.eng, self.k6_stack, self.batch, 1080, 1920
        kw = dict(max_iters=100, dilate_steps=16, scan_after=64)
        nb, px, words = len(stack), h * w, -(-h // 32) * w
        f, p = pack_thresh(stack)
        flags = torch.empty((nb, 2, 2), dtype=torch.int32, device=self.dev)
        converge(f, p, flags, h, **kw)
        r1, r2 = flags[:, 0, 0].tolist(), flags[:, 1, 0].tolist()
        k6_ops = sum(a * round_ops(words, 16, False) + (b - a) * round_ops(words, 16, True)
                     for a, b in zip(r1, r2)) + nb * (4 * px + 2 * px)
        for label, nbytes, ops, run, plain in (
                ("pack_thresh x8 (one launch)", nb * (px + 2 * 4 * words), nb * 4 * px,
                 lambda: pack_thresh(stack), lambda: pack_thresh_plain(stack)),
                ("hysteresis_fused_batched x8 (4 launches)", nb * 2 * px, k6_ops,
                 lambda: hysteresis_fused_batched(stack, **kw),
                 lambda: hysteresis_fused_batched_plain(stack, **kw))):
            ev = self.time_ms(lambda _: run(), 5 if "pack" in label else 1,
                              reps=5 if "pack" in label else 3)
            busy = device_time_ms_per_call(run, calls=3, device=self.dev)
            pl = self.time_ms(lambda _: plain(), 1, reps=1)
            bound, by = bound_ms(nbytes, ops)
            print(f"time {label}, 1080p maps: events {ev!r} ms a call, busy {busy!r} ms, plain "
                  f"{pl!r} ms, bound {bound!r} ms ({by}) (rounds per map {list(zip(r1, r2))})")

        for what, frames in (("7 scenes + spiral", batch), ("8 scenes", torch.stack(self.frames[:8]))):
            for label, run in (("x8 batch, one call", lambda: eng.process_all(frames)),
                               ("8 single calls", lambda: [eng.process_all(x) for x in frames])):
                ev = self.time_ms(lambda _: run(), 1, reps=7) / nb
                busy = device_time_ms_per_call(run, calls=3, device=self.dev)
                busy = None if busy is None else busy / nb  # None: the trace shows no device time
                wall = statistics.median(self.wall_ms(run, nb) for _ in range(7))
                print(f"time process_all 1080p, {what}, {label}: events {ev!r} ms/frame, busy "
                      f"{busy!r} ms/frame, wall {wall!r} ms/frame (medians of 7; busy over 3 calls)")

    def check_tiles(self, label: str, eng, frames, loop_rounds=None, max_rounds: int = 2,
                    **schedule) -> None:
        """Hold every kernel of the sharded HYSTER path against its plain
        version at ``eng``'s own tile shapes on ``frames``, kernel and plain
        from the same state: the export pack and its phase 1 (K8); the two
        refreshes before the loop; up to ``max_rounds`` collective rounds of
        the host loop step by step (K9 as ``saturate_packed``'s two round
        kernels, then the refresh); the one-launch round loop
        (``sharded_loop``) from the export's state against the host loop with
        the plain saturate and refresh, at a budget of 0 (its prologue, the
        two refreshes, alone) and over ``loop_rounds`` rounds at most
        (default: the config's budget); the core unpack (K10). ``schedule``
        overrides the round arguments."""
        torch = self.torch
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack_plain, ff_pack_tiles
        from cudacam_tpu_torch.ops.cuda.halo import halo_exchange, halo_exchange_plain
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            saturate_packed, saturate_packed_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase1_plain, loop_layout, unpack_core, unpack_core_plain,
        )
        from cudacam_tpu_torch.parallel.packed_halo import sharded_loop, sharded_loop_plain

        pipe, cfg = eng.pipeline(), eng.config
        t, g = pipe.tiling, pipe.geo
        hk = dict(hyster_kwargs(cfg), **schedule)
        thr = eng._thresholds()
        one = lambda v: torch.tensor([v], dtype=torch.int32, device=self.dev)  # noqa: E731
        grid = (len(frames), t.ny, t.nx)

        def step(names, kernel, plain, *state):
            twin = [s.clone() for s in state]
            plain(*twin)
            kernel(*state)
            for name in names:
                for a, b in zip(state, twin):
                    self.diff(name, a, b)

        f, p = ff_pack_tiles(frames, thr, t)
        planes = [ff_pack_plain(fr, thr, tiling=t) for fr in frames]
        self.diff("ff_pack_export", f, torch.cat([a for a, _ in planes]))
        self.diff("ff_pack_export", p, torch.cat([b for _, b in planes]))
        flags = torch.zeros((f.shape[0], 2, 2), dtype=torch.int32, device=self.dev)
        step(("hyst_phase1",), lambda x, fl: hyst_phase1(x, p, fl, g.ext_h, **hk),
             lambda x, fl: hyst_phase1_plain(x, p, fl, g.ext_h, **hk), f, flags)
        export = (f.clone(), p.clone(), flags.clone())
        step(("halo_exchange",), lambda x: halo_exchange(x, grid, g),
             lambda x: halo_exchange_plain(x, grid, g), p)
        pending = one(0)
        step(("halo_exchange",),
             lambda x, pe: halo_exchange(x, grid, g, grow=flags[:, 0, 1], pending=pe),
             lambda x, pe: halo_exchange_plain(x, grid, g, grow=flags[:, 0, 1], pending=pe),
             f, pending)
        taken, per_round = 0, []
        while taken < max_rounds and int(pending):
            step(("saturate_phase1", "saturate_phase2"),
                 lambda x, fl: saturate_packed(x, p, fl, g.ext_h, **hk),
                 lambda x, fl: saturate_packed_plain(x, p, fl, g.ext_h, **hk), f, flags)
            r1 = flags[:, 0, 0].tolist()
            per_round.append((r1, [b - a for a, b in zip(r1, flags[:, 1, 0].tolist())]))
            step(("halo_exchange",),
                 lambda x, pe: halo_exchange(x, grid, g, grow=flags[:, 1, 1], pending=pe),
                 lambda x, pe: halo_exchange_plain(x, grid, g, grow=flags[:, 1, 1], pending=pe),
                 f, pending)
            taken += 1
        budget = cfg.max_hysteresis_iters if loop_rounds is None else loop_rounds
        self.loop_at_budget_0(export, grid, g, hk)
        fk, pk, flk = (s.clone() for s in export)
        rk = sharded_loop(fk, pk, flk, grid, g, max_rounds=budget, **hk)
        rp = sharded_loop_plain(*export, grid, g, max_rounds=budget, **hk)
        for a, b in ((fk, export[0]), (pk, export[1]), (flk, export[2]), (rk, rp)):
            self.diff("sharded_loop", a, b)
        out = torch.full((len(frames), cfg.height, cfg.width), 7, dtype=torch.uint8,
                         device=self.dev)
        want = unpack_core_plain(fk, out.clone(), t)
        self.diff("unpack_core", unpack_core(fk, out, t), want)
        print(f"{label}: ff_pack_export, hyst_phase1, halo_exchange, saturate_phase1/2 over "
              f"{taken} collective rounds, sharded_loop at budget 0 and over {int(rk)} rounds "
              f"(budget {budget}) "
              f"and unpack_core == plain at its {t.ny}x{t.nx} tiles of {g.ext_h}x{g.ext_w} "
              f"({core_runs(out, t)})")
        lay = loop_layout(grid, g.ext_h, g.ext_w, hk["dilate_steps"])
        print(f"  loop layout {json.dumps(lay)}")
        for r, (r1, r2) in enumerate(per_round):
            print(f"  collective round {r}: phase-1 rounds a tile {r1}, phase-2 {r2}")

    def loop_at_budget_0(self, export, grid, g, hk) -> None:
        """``sharded_loop`` at a budget of 0 from the (f, p, flags) state
        ``export``: its prologue alone, one launch, the two refreshes before
        the reference's round loop; both planes, the flags (untouched) and 0
        rounds equal to the host loop's."""
        from cudacam_tpu_torch.ops import cuda as kernels
        from cudacam_tpu_torch.parallel.packed_halo import sharded_loop, sharded_loop_plain

        got, want = [s.clone() for s in export], [s.clone() for s in export]
        kernels.reset_launch_counts()
        rk = sharded_loop(*got, grid, g, max_rounds=0, **hk)
        counts = kernels.launch_counts()
        require(counts["sharded_loop"] == 1 and counts["halo_exchange"] == 0,
                f"sharded_loop at budget 0 launched {dict(counts)}")
        rp = sharded_loop_plain(*want, grid, g, max_rounds=0, **hk)
        for a, b in zip(got + [rk], want + [rp]):
            self.diff("sharded_loop", a, b)
        self.diff("sharded_loop", got[2], export[2])
        require(int(rk) == 0, f"sharded_loop at budget 0 took {int(rk)} rounds")

    def spiral_loop(self, f, p, flags, grid, g, hk, budget):
        """``sharded_loop`` on the 1080p spiral's export state at ``budget``
        collective rounds (the cap): equal to ``sharded_loop_plain`` (planes,
        flags, rounds), its CUDA-event ms and the plain version's, and its
        bound from the rounds each tile takes, counted on the host loop with
        the saturate's round kernels. Returns (ms, plain ms, bound, collective
        rounds, inner rounds (the most any tile takes a phase, summed),
        {(phase-1, phase-2): collective rounds})."""
        from collections import Counter
        from cudacam_tpu_torch.ops.cuda.halo import halo_exchange
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
        from cudacam_tpu_torch.parallel.packed_halo import (
            packed_hysteresis_loop, sharded_loop, sharded_loop_plain,
        )

        state = lambda: (f.clone(), p.clone(), flags.clone())  # noqa: E731
        run = lambda s: sharded_loop(*s, grid, g, max_rounds=budget, **hk)  # noqa: E731
        ms = self.time_ms(run, 1, reps=3, setup=state)
        got, want = state(), state()
        rk = run(got)
        t0 = time.perf_counter()
        rp = sharded_loop_plain(*want, grid, g, max_rounds=budget, **hk)
        self.torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for a, b in zip(got + (rk,), want + (rp,)):
            self.diff("sharded_loop", a, b)
        fc, pc, flc = state()
        per = []

        def counting(ff, pp):
            saturate_packed(ff, pp, flc, g.ext_h, **hk)
            r1 = flc[:, 0, 0].tolist()
            per.append((r1, [b - a for a, b in zip(r1, flc[:, 1, 0].tolist())]))
            return flc[:, 1, 1]

        taken = int(packed_hysteresis_loop(
            fc, pc, flc[:, 0, 1], counting, lambda x, **k: halo_exchange(x, grid, g, **k), budget))
        require(taken == int(rk), f"spiral cap {budget}: {int(rk)} rounds, the host loop {taken}")
        words = g.hw * g.ext_w
        ops = sum(sum(r1) * round_ops(words, hk["dilate_steps"], False)
                  + sum(r2) * round_ops(words, hk["dilate_steps"], True) for r1, r2 in per)
        refresh = refresh_work(g, grid)
        bound = bound_ms(3 * 4 * words * f.shape[0] + (taken + 2) * refresh[0],
                         ops + (taken + 2) * refresh[1])
        inner = sum(max(r1) + max(r2) for r1, r2 in per)
        pairs = dict(Counter((max(r1), max(r2)) for r1, r2 in per))
        return ms, plain_ms, bound, taken, inner, pairs

    def unpack_core_offsets(self) -> None:
        """``unpack_core`` against its plain version on cores at bit offsets
        e_top % 32 of 1, 31 and 33, lane offsets, and widths and pitches that
        are not multiples of 16 (a head and a tail at every column split)."""
        torch = self.torch
        from cudacam_tpu_torch.ops.cuda.feedforward import Tiling
        from cudacam_tpu_torch.ops.cuda.megakernel import unpack_core, unpack_core_plain

        for ny, nx, h_loc, w_loc, e_top, e_left in ((2, 3, 45, 37, 1, 5), (2, 3, 45, 37, 31, 64),
                                                    (3, 2, 33, 17, 33, 17),
                                                    (4, 2, 1080, 3839, 31, 63)):
            t = Tiling(ny, nx, h_loc, w_loc, e_top, e_left, e_top + h_loc + 3, e_left + w_loc + 5,
                       (ny * h_loc, nx * w_loc))
            f = torch.randint(-2**31, 2**31 - 1, (2 * t.tiles, -(-t.ext_h // 32), t.ext_w),
                              dtype=torch.int32, device=self.dev)
            out = torch.full((2, ny * h_loc, nx * w_loc), 7, dtype=torch.uint8, device=self.dev)
            want = unpack_core_plain(f, out.clone(), t)
            require(not (want == 7).any(), "unpack_core_plain left a byte unwritten")
            self.diff("unpack_core", unpack_core(f, out, t), want)
            print(f"unpack_core == plain at cores of {h_loc}x{w_loc} from bit {e_top}, lane "
                  f"{e_left}, {ny}x{nx} a frame ({core_runs(out, t)})")

    def phase_sharded(self) -> None:
        """The tile-sharded path on a one-card mesh: for each mesh, every
        kernel of the path (K8: ``ff_pack_export`` + ``hyst_phase1``; the
        refreshes; K9 as the host loop's round kernels; the one-launch round
        loop; K10: ``unpack_core``) against its plain version at that mesh's
        tile shapes (:meth:`check_tiles`); then the sharded engine, counts
        set to 0 just before and read just after (four launches a call at
        caps 100 and 400, no ``halo_exchange``), against ``CannyEngine`` and
        the spiral, cut off by the cap, against the plain route on the CPU;
        then the host loop on this card with an injected local operator
        (:meth:`injected_route`) and the distributed route (the host loop) on
        a one-process NCCL group."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from cudacam_tpu_torch import CannyConfig, CannyStage
        from cudacam_tpu_torch.engine import CannyEngine, ShardedCannyEngine
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame
        from cudacam_tpu_torch.parallel import make_mesh

        dev = self.dev
        h, w = 1080, 1920
        cfg = CannyConfig(height=h, width=w)
        eng1080 = CannyEngine(cfg, device="cuda")
        scene = torch.from_numpy(make_scene(h, w, seed=0)).to(dev)
        spiral = torch.from_numpy(make_spiral_frame(h, w)).to(dev)
        batch = torch.stack([scene, spiral])
        sh = ShardedCannyEngine(cfg, make_mesh(1, 2, 2))
        sh.process(batch)  # thresholds to the device
        self.check_tiles("1080p (1, 2, 2), scene + spiral, BGR", sh, batch, loop_rounds=3)
        self.check_tiles("1080p (1, 2, 2), scene + spiral, mono, scan_after 2", sh,
                         batch[..., 1].contiguous(), loop_rounds=3, scan_after=2)

        # Export tilings whose tile pitch is not 16-byte aligned: 959 BGR
        # columns of a 1918-pixel frame (cp.async chunks), 968 of a
        # 1936-pixel frame (TMA at unaligned tile origins); a batch view one
        # frame in. On the first, whose tiles' bottom strip starts in the
        # word its bottom halo slot starts in, the round loop at budgets 0
        # and 100 and the refresh, each against its plain version.
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs, pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack_plain, ff_pack_tiles
        from cudacam_tpu_torch.ops.cuda.halo import halo_exchange, halo_exchange_plain
        from cudacam_tpu_torch.ops.cuda.megakernel import mega_export
        from cudacam_tpu_torch.parallel import build_sharded_pipeline
        from cudacam_tpu_torch.parallel.packed_halo import sharded_loop, sharded_loop_plain

        thr = torch.tensor([10, 40], dtype=torch.int32, device=dev)
        for (hh, ww), mesh in (((66, 1918), (1, 2, 2)), ((64, 1936), (1, 1, 2))):
            cfg_t = CannyConfig(height=hh, width=ww)
            pipe_t = build_sharded_pipeline(cfg_t, make_mesh(*mesh))
            t = pipe_t.tiling
            fr = torch.from_numpy(np.stack([make_scene(hh, ww, seed=s) for s in range(3)])).to(dev)
            for x in (fr, fr[..., 1].contiguous(), fr[1:]):
                f, p = ff_pack_tiles(x, thr, t)
                planes = [ff_pack_plain(y, thr, tiling=t) for y in x]
                self.diff("ff_pack_export", f, torch.cat([a for a, _ in planes]))
                self.diff("ff_pack_export", p, torch.cat([b for _, b in planes]))
            print(f"ff_pack_export == plain at {hh}x{ww} over {mesh} (tiles of "
                  f"{t.ext_h}x{t.ext_w} from column pitch {t.w_loc}), BGR, mono, a view")
            if mesh != (1, 2, 2):
                continue
            g_t, hk_t, grid_t = pipe_t.geo, hyster_kwargs(cfg_t), (len(fr), t.ny, t.nx)
            export = mega_export(fr, thr, t, **pipeline_kwargs(cfg_t))
            self.loop_at_budget_0(export, grid_t, g_t, hk_t)
            got, want = [s.clone() for s in export], [s.clone() for s in export]
            rk = sharded_loop(*got, grid_t, g_t, max_rounds=100, **hk_t)
            rp = sharded_loop_plain(*want, grid_t, g_t, max_rounds=100, **hk_t)
            for a, b in zip(got + [rk], want + [rp]):
                self.diff("sharded_loop", a, b)
            pk, pp = torch.zeros(1, dtype=torch.int32, device=dev), torch.zeros(
                1, dtype=torch.int32, device=dev)
            xk, xp = export[0].clone(), export[0].clone()
            halo_exchange(xk, grid_t, g_t, grow=export[2][:, 0, 1], pending=pk)
            halo_exchange_plain(xp, grid_t, g_t, grow=export[2][:, 0, 1], pending=pp)
            self.diff("halo_exchange", xk, xp)
            self.diff("halo_exchange", pk, pp)
            print(f"  {hh}x{ww} over {mesh}: sharded_loop at budgets 0 and 100 ({int(rk)} "
                  f"rounds) and halo_exchange == plain on 3 frames")

        self.unpack_core_offsets()

        main = dict(ff_pack_export=1, hyst_phase1=1, halo_exchange=0, sharded_loop=1,
                    unpack_core=1, saturate_phase1=0, saturate_phase2=0, ff_pack=0, unpack=0)
        self.sharded = {}

        def run(label, cfg_s, mesh, frames, expect, want, stage=CannyStage.HYSTER, check=False,
                keep=True):
            eng = ShardedCannyEngine(cfg_s, make_mesh(*mesh))
            eng.process(frames, stage)  # thresholds to the device before the count
            out = self.path(label, lambda: eng.process(frames, stage), expect)
            rounds = eng.pipeline(stage).rounds
            rounds = None if rounds is None else int(rounds)
            require(torch.equal(out, want), f"{label} differs")
            print(f"{label}: == reference, {rounds} collective rounds")
            if keep:
                self.sharded[label] = (eng, frames, stage, rounds)
            if check:
                self.check_tiles(label, eng, frames)
            return eng, out, rounds

        # 8K (1, 4, 2): one scene; equal to the unsharded engine, at cap 100 and 400.
        h8, w8 = 4320, 7680
        cfg8 = CannyConfig(height=h8, width=w8)
        f8 = torch.from_numpy(make_scene(h8, w8, seed=0)).to(dev)[None]
        self.eng8 = CannyEngine(cfg8, device="cuda")
        want8 = self.eng8.process(f8)
        run("sharded HYSTER 8K (1, 4, 2)", cfg8, (1, 4, 2), f8, main, want8, check=True)
        run("sharded HYSTER 8K (1, 4, 2), cap 400",
            dataclasses.replace(cfg8, max_hysteresis_iters=400), (1, 4, 2), f8, main, want8,
            keep=False)
        # 4K x4 (2, 2, 1): a batch of four scenes.
        h4, w4 = 2160, 3840
        cfg4 = CannyConfig(height=h4, width=w4)
        f4 = torch.from_numpy(np.stack([make_scene(h4, w4, seed=s) for s in range(4)])).to(dev)
        self.eng4 = CannyEngine(cfg4, device="cuda")
        run("sharded HYSTER 4K x4 (2, 2, 1)", cfg4, (2, 2, 1), f4, main, self.eng4.process(f4),
            check=True)
        # 1080p (1, 1, 1): the geometry is the raw frame.
        run("sharded HYSTER 1080p (1, 1, 1)", cfg, (1, 1, 1), scene[None], main,
            eng1080.process(scene)[None], check=True)
        # The spiral on (1, 2, 2): growth across tiles, cut off by the cap at
        # 100 and 400; against the plain route (the CPU: the host loop) on the
        # same frame, its round count included.
        for cap in (100, 400):
            cfg_c = dataclasses.replace(cfg, max_hysteresis_iters=cap)
            plain_eng = ShardedCannyEngine(cfg_c, make_mesh(1, 2, 2), device="cpu")
            t0 = time.perf_counter()
            plain = plain_eng.process(spiral[None].cpu())
            plain_s = time.perf_counter() - t0
            suffix = "" if cap == 100 else ", cap 400"
            _, sp_out, sp_rounds = run(f"sharded HYSTER 1080p spiral (1, 2, 2){suffix}", cfg_c,
                                       (1, 2, 2), spiral[None], main, plain.to(dev),
                                       keep=cap == 100)
            require(sp_rounds == int(plain_eng.pipeline().rounds) <= cap,
                    f"spiral cap {cap}: {sp_rounds} rounds, the host loop "
                    f"{int(plain_eng.pipeline().rounds)}")
            print(f"  cap {cap}: {int((sp_out == 255).sum())} finals (the plain "
                  f"route on the CPU took {plain_s:.1f} s; the unsharded engine's, cut off by "
                  f"its own cap: {int((eng1080.process(spiral) == 255).sum())})")
        # THRESH on (1, 2, 2): the display route, one ff_stages per tile.
        run("sharded THRESH 1080p (1, 2, 2)", cfg, (1, 2, 2), scene[None],
            dict(ff_stages=4, ff_pack_export=0, unpack_core=0, sharded_loop=0),
            eng1080.process(scene, CannyStage.THRESH)[None], CannyStage.THRESH)

        # No host sync on the single-card sharded path.
        calls = [lambda e=e, fr=fr, st=st: e.process(fr, st)
                 for e, fr, st, _ in self.sharded.values()]
        for call in calls:
            call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for call in calls:
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("sharded process() on every mesh: no host sync under set_sync_debug_mode('error')")
        self.injected_route(cfg, spiral)
        self.distributed_route(cfg, spiral)

    def injected_route(self, cfg, spiral) -> None:
        """The host loop on a one-card (1, 2, 2) mesh, as a pipeline with an
        injected local operator takes it (``build_sharded_pipeline(...,
        local_saturate=)``, here K9 through ``saturate_packed``): the
        refresh kernel (``halo_exchange``) twice before the loop and once a
        round, the pending flag read once a round; the spiral cut off by a
        short budget, equal to the one-card loop, rounds included."""
        torch = self.torch
        import dataclasses
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
        from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh

        cap = 8
        cfg_c = dataclasses.replace(cfg, max_hysteresis_iters=cap, hysteresis_scan_after=4)
        mesh = make_mesh(1, 2, 2)
        geo = build_sharded_pipeline(cfg_c, mesh).geo

        def k9(f, p):
            flags = torch.zeros((f.shape[0], 2, 2), dtype=torch.int32, device=f.device)
            return f, saturate_packed(f, p, flags, geo.ext_h, **hyster_kwargs(cfg_c))[1]

        run = build_sharded_pipeline(cfg_c, mesh, local_saturate=k9)
        thr = torch.tensor([cfg_c.low_threshold, cfg_c.high_threshold], dtype=torch.int32,
                           device=self.dev)
        frames = spiral[None]
        run(frames, thr)
        out = self.path("sharded HYSTER 1080p spiral (1, 2, 2), injected local operator "
                        "(the host loop on one card)", lambda: run(frames, thr),
                        dict(ff_pack_export=1, hyst_phase1=1, saturate_phase1=cap,
                             saturate_phase2=cap, sharded_loop=0, halo_exchange=cap + 2,
                             unpack_core=1))
        local = build_sharded_pipeline(cfg_c, mesh)
        require(torch.equal(out, local(frames, thr)), "the injected route differs")
        require(int(run.rounds) == int(local.rounds) == cap, f"injected rounds {int(run.rounds)}")
        print(f"injected local operator on one card: == the one-card loop, {cap} rounds, "
              f"halo_exchange {cap + 2} launches")

    def distributed_route(self, cfg, spiral) -> None:
        """The distributed route on this card: a one-process NCCL group, a
        (1, 1, 1) mesh over it, the spiral cut off by a short budget. Its
        round loop is the host loop (K9 as two round-kernel launches a
        round, the plain refresh, the pending flag all-reduced and read once
        a round); its output and rounds equal the one-card loop's."""
        torch = self.torch
        import dataclasses
        import socket
        import torch.distributed as dist
        from cudacam_tpu_torch.engine import ShardedCannyEngine
        from cudacam_tpu_torch.parallel import distributed, make_mesh

        cap = 8
        cfg_c = dataclasses.replace(cfg, max_hysteresis_iters=cap, hysteresis_scan_after=4)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        distributed.initialize(f"localhost:{port}", num_processes=1, process_id=0, backend="nccl")
        try:
            mesh = distributed.pod_mesh(batch=1)
            require(mesh.distributed and (mesh.batch, mesh.rows, mesh.cols) == (1, 1, 1),
                    f"pod mesh {mesh}")
            eng = ShardedCannyEngine(cfg_c, mesh)
            frames = spiral[None]
            eng.process(frames)
            out = self.path("sharded HYSTER 1080p spiral, one-process NCCL mesh (the host loop)",
                            lambda: eng.process(frames),
                            dict(ff_pack_export=1, hyst_phase1=1, saturate_phase1=cap,
                                 saturate_phase2=cap, sharded_loop=0, halo_exchange=0,
                                 unpack_core=1))
            local = ShardedCannyEngine(cfg_c, make_mesh(1, 1, 1))
            require(torch.equal(out, local.process(frames)), "the distributed route differs")
            require(int(eng.pipeline().rounds) == int(local.pipeline().rounds) == cap,
                    f"distributed rounds {int(eng.pipeline().rounds)}")
            print(f"distributed route (NCCL, one process): == the one-card loop, {cap} rounds")
        finally:
            dist.destroy_process_group()

    def phase_sharded_timing(self) -> None:
        """K8, K10, the refresh and the round loop at the 8K (1, 4, 2) tiles
        and K9 where it works (the 1080p spiral over (1, 2, 2) at its first
        collective round), kernel against plain, with their bounds; ms/frame
        of each sharded path beside the unsharded engine and the host loop
        (one readback a round) on the same frames."""
        torch = self.torch
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs, pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack_plain, ff_pack_tiles
        from cudacam_tpu_torch.ops.cuda.halo import halo_exchange, halo_exchange_plain
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            saturate_packed, saturate_packed_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase1_plain, hyst_phase2, hyst_phase2_plain, mega_export,
            unpack_core, unpack_core_plain,
        )
        from cudacam_tpu_torch.parallel.packed_halo import (
            packed_hysteresis_loop, sharded_loop, sharded_loop_plain,
        )

        dev = self.dev
        eng, frames, _, _ = self.sharded["sharded HYSTER 8K (1, 4, 2)"]
        pipe, cfg = eng.pipeline(), eng.config
        t, g = pipe.tiling, pipe.geo
        thr, hk = eng._thresholds(), hyster_kwargs(cfg)
        h, w = cfg.height, cfg.width
        ntile = t.tiles
        words = g.hw * g.ext_w
        ds = hk["dilate_steps"]
        one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731

        self.ms["ff_pack_export"] = self.time_ms(lambda _: ff_pack_tiles(frames, thr, t), 20)
        self.plain_ms["ff_pack_export"] = self.time_ms(
            lambda _: ff_pack_plain(frames[0], thr, tiling=t), 1, reps=3)
        self.set_bound("ff_pack_export", 3 * h * w + 2 * 4 * words * ntile,
                       chain_ops(cfg.kernel_size) * g.ext_h * g.ext_w * ntile)
        f, p, flags = mega_export(frames, thr, t, **pipeline_kwargs(cfg))
        grid = (1, t.ny, t.nx)
        x_state = lambda: (f.clone(), one(0))  # noqa: E731
        self.ms["halo_exchange"] = self.time_ms(
            lambda s: halo_exchange(s[0], grid, g, grow=flags[:, 0, 1], pending=s[1]), 50,
            setup=x_state)
        self.plain_ms["halo_exchange"] = self.time_ms(
            lambda s: halo_exchange_plain(s[0], grid, g, grow=flags[:, 0, 1], pending=s[1]), 5,
            setup=x_state)
        refresh = refresh_work(g, grid)
        self.set_bound("halo_exchange", *refresh)

        # The round loop from the export's state (8K scene 0: the tiles meet
        # in one collective round), kernel and plain; its bound from the
        # rounds its saturates take, counted on the plain host loop.
        loop_state = lambda: (f.clone(), p.clone(), flags.clone())  # noqa: E731
        kw = dict(hk, max_rounds=cfg.max_hysteresis_iters)
        self.ms["sharded_loop"] = self.time_ms(
            lambda s: sharded_loop(*s, grid, g, **kw), 20, setup=loop_state)
        self.plain_ms["sharded_loop"] = self.time_ms(
            lambda s: sharded_loop_plain(*s, grid, g, **kw), 1, reps=1, setup=loop_state)
        fc, pc, flc = loop_state()
        sat_rounds = []

        def counting(ff, pp):
            saturate_packed_plain(ff, pp, flc, g.ext_h, **hk)
            sat_rounds.append((int(flc[:, 0, 0].sum()), int((flc[:, 1, 0] - flc[:, 0, 0]).sum())))
            return flc[:, 1, 1]

        taken = int(packed_hysteresis_loop(
            fc, pc, flc[:, 0, 1], counting,
            lambda x, **k2: halo_exchange_plain(x, grid, g, **k2), cfg.max_hysteresis_iters))
        loop_ops = sum(r1 * round_ops(words, ds, False)
                       + r2 * round_ops(words, ds, True) for r1, r2 in sat_rounds)
        # the prologue's two refreshes (both planes), then one a collective round
        self.set_bound("sharded_loop", 3 * 4 * words * ntile + (taken + 2) * refresh[0],
                       loop_ops + (taken + 2) * refresh[1])
        fx = fc
        out = torch.empty((1, h, w), dtype=torch.uint8, device=dev)
        self.ms["unpack_core"] = self.time_ms(lambda _: unpack_core(fx, out, t), 50)
        self.plain_ms["unpack_core"] = self.time_ms(lambda _: unpack_core_plain(fx, out, t), 3)
        core_words = ntile * (-(-(g.e_top + g.h_loc) // 32) - g.e_top // 32) * g.w_loc
        self.set_bound("unpack_core", 4 * core_words + h * w, 2 * h * w)

        # K9 where it works: at 8K both phases find a converged state, so the
        # saturate's two round kernels are timed on the spiral over (1, 2, 2)
        # at the state of its first collective round, the bound counted from
        # the rounds each tile takes there.
        seng, sfr, _, _ = self.sharded["sharded HYSTER 1080p spiral (1, 2, 2)"]
        sp, scfg = seng.pipeline(), seng.config
        st, sg, shk = sp.tiling, sp.geo, hyster_kwargs(scfg)
        sf, spl, sfl = mega_export(sfr, seng._thresholds(), st, **pipeline_kwargs(scfg))
        sgrid, pend = (len(sfr), st.ny, st.nx), one(0)
        halo_exchange(spl, sgrid, sg)
        halo_exchange(sf, sgrid, sg, grow=sfl[:, 0, 1], pending=pend)
        require(int(pend) == 1, "spiral: no collective round pending after the export")
        sat_state = lambda: (sf.clone(), sfl.clone())  # noqa: E731
        self.ms["saturate_phase1"] = self.time_ms(
            lambda s: hyst_phase1(s[0], spl, s[1], sg.ext_h, **shk), 5, setup=sat_state)
        self.plain_ms["saturate_phase1"] = self.time_ms(
            lambda s: hyst_phase1_plain(s[0], spl, s[1], sg.ext_h, **shk), 1, reps=1,
            setup=sat_state)
        fs, fls = sat_state()
        hyst_phase1(fs, spl, fls, sg.ext_h, **shk)
        p2_state = lambda: (fs.clone(), fls.clone())  # noqa: E731
        p2 = dict(dilate_steps=shk["dilate_steps"], max_iters=shk["max_iters"])
        self.ms["saturate_phase2"] = self.time_ms(
            lambda s: hyst_phase2(s[0], spl, s[1], sg.ext_h, **p2), 5, setup=p2_state)
        self.plain_ms["saturate_phase2"] = self.time_ms(
            lambda s: hyst_phase2_plain(s[0], spl, s[1], sg.ext_h, **p2), 1, reps=1,
            setup=p2_state)
        fs2, fls2 = sat_state()
        saturate_packed(fs2, spl, fls2, sg.ext_h, **shk)
        hyst_phase2(fs, spl, fls, sg.ext_h, **p2)
        require(torch.equal(fs, fs2) and torch.equal(fls, fls2),
                "saturate_packed differs from its two round kernels")
        r1, r2 = fls[:, 0, 0].tolist(), (fls[:, 1, 0] - fls[:, 0, 0]).tolist()
        grew = int(fls[:, 0, 1].sum())  # tiles phase 2 continues
        require(sum(r2) > 0, f"spiral saturate: phase 2 took no round ({r1}, {r2})")
        sw = sg.hw * sg.ext_w
        sds = shk["dilate_steps"]
        self.set_bound("saturate_phase1", 3 * 4 * sw * len(r1),
                       sum(r1) * round_ops(sw, sds, False))
        self.set_bound("saturate_phase2", 3 * 4 * sw * grew,
                       sum(r2) * round_ops(sw, sds, True))
        spiral = {}
        for cap in (100, 400):
            spiral[cap] = self.spiral_loop(sf, spl, sfl, sgrid, sg, dict(shk, max_iters=cap), cap)

        for name, where in (("ff_pack_export", "8K (1, 4, 2) tiles"),
                            ("halo_exchange", "8K (1, 4, 2) tiles"),
                            ("sharded_loop", f"8K (1, 4, 2) tiles, {taken} collective round(s), "
                                             f"saturate rounds {sat_rounds}"),
                            ("unpack_core", "8K (1, 4, 2) tiles"),
                            ("saturate_phase1", "1080p spiral (1, 2, 2), first round"),
                            ("saturate_phase2", "1080p spiral (1, 2, 2), first round")):
            print(f"time {name}: kernel {self.ms[name]!r} ms, plain {self.plain_ms[name]!r} ms, "
                  f"bound {self.bound[name][0]!r} ms ({self.bound[name][1]}) ({where})")
        print(f"  saturate on the spiral's first collective round, rounds per tile: phase 1 "
              f"{r1}, phase 2 {r2} ({grew} tiles continue)")
        for cap, (ms, plain_ms, bound, taken_s, inner, pairs) in spiral.items():
            print(f"time sharded_loop on the 1080p spiral (1, 2, 2) from the export's state, cap "
                  f"{cap}: kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound[0]!r} ms "
                  f"({bound[1]}; {taken_s} collective rounds, {inner} inner rounds, "
                  f"{ms * 1e3 / max(inner, 1)!r} µs an inner round; (phase-1, phase-2) rounds "
                  f"a collective round, the most any tile takes: {pairs})")

        def host_loop(seng, fr):
            """The same HYSTER frame through the host loop on this card (the
            distributed route's loop: K9 as two launches a round, the refresh
            kernel, one readback of the pending flag a round)."""
            sp = seng.pipeline()
            f, p, flags = mega_export(fr, seng._thresholds(), sp.tiling, **pipeline_kwargs(sp.cfg))
            packed_hysteresis_loop(f, p, flags[:, 0, 1], sp._saturate(flags),
                                   lambda x, **kw: sp.mesh.exchange(x, sp.geo, **kw),
                                   sp.cfg.max_hysteresis_iters)
            out = torch.empty((len(fr), sp.cfg.height, sp.cfg.width), dtype=torch.uint8,
                              device=dev)
            return unpack_core(f, out, sp.tiling)

        refs = {"sharded HYSTER 8K (1, 4, 2)": lambda fr: self.eng8.process(fr[0]),
                "sharded HYSTER 4K x4 (2, 2, 1)": self.eng4.process,
                "sharded HYSTER 1080p (1, 1, 1)": lambda fr: self.eng.process(fr[0]),
                "sharded HYSTER 1080p spiral (1, 2, 2)": lambda fr: self.eng.process(fr[0]),
                "sharded THRESH 1080p (1, 2, 2)": lambda fr: self.eng.process(fr[0], 4)}
        for label, (seng, fr, stage, rounds) in self.sharded.items():
            n = len(fr)
            reps = 3 if "spiral" in label else 7
            run_s = lambda _: seng.process(fr, stage)  # noqa: E731
            run_u = lambda _: refs[label](fr)  # noqa: E731
            # unsharded, sharded, sharded, unsharded: the two compared in turns
            times = [self.time_ms(fn, 1, reps=reps) / n for fn in (run_u, run_s, run_s, run_u)]
            line = (f"time {label}: sharded {times[1]!r} / {times[2]!r} ms/frame, unsharded "
                    f"engine {times[0]!r} / {times[3]!r} ms/frame (same frames, medians of {reps})")
            if rounds is not None:
                require(torch.equal(host_loop(seng, fr), seng.process(fr)),
                        f"{label}: the host loop differs")
                hl_ms = self.time_ms(lambda _: host_loop(seng, fr), 1, reps=reps) / n
                line += f"; {rounds} collective rounds; the host loop instead {hl_ms!r} ms/frame"
            print(line)

    def phase_split(self) -> None:
        """K11: ``split_converge`` against its plain version at 8K, the engine
        with ``continuation='split'``, its launch counts and its time beside
        the whole-frame continuation (K2)."""
        torch = self.torch
        import dataclasses
        from cudacam_tpu_torch import CannyConfig
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame
        from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            converge_packed_split, converge_packed_split_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            SPLIT_CHUNK, canny_mega, split_count, split_layout, unpack_plain,
        )

        dev = self.dev
        h, w = 4320, 7680
        cfg = CannyConfig(height=h, width=w)
        thr = torch.tensor([10, 40], dtype=torch.int32, device=dev)
        spiral = torch.from_numpy(make_spiral_frame(h, w)).to(dev)
        scene = torch.from_numpy(make_scene(h, w, seed=0)).to(dev)
        require(split_count(h, w) == 2, f"8K n_split {split_count(h, w)}")

        def phase1(frame, c):
            return canny_mega(frame, thr, **pipeline_kwargs(c))

        def both(label, f, p, flags, c, n_split):
            """Kernel and plain from the same phase-1 exit state."""
            kw = dict(dilate_steps=c.hysteresis_inner_steps, scan_after=0,
                      max_iters=c.max_hysteresis_iters, chunk=SPLIT_CHUNK)
            fk, flk, fp, flp = f.clone(), flags.clone(), f.clone(), flags.clone()
            converge_packed_split(fk, p, flk, h, n_split, **kw)
            t0 = time.perf_counter()
            converge_packed_split_plain(fp, p, flp, h, n_split, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            self.diff("split_converge", fk, fp)
            self.diff("split_converge", flk, flp)
            print(f"split_converge == plain on {label}, n_split {n_split}: flags {flk.tolist()}, "
                  f"{int((unpack_plain(fk, h) == 255).sum())} finals (plain took {plain_s:.2f} s)")
            return fk, flk, plain_s

        # (a) the spiral at its phase-1 exit: cut off by the round budget.
        f, p, flags = phase1(spiral, cfg)
        require(flags[0].tolist() == [cfg.hysteresis_scan_after, 1], f"8K spiral {flags.tolist()}")
        for n_split in (2, 4):
            fk, flk, plain_s = both("the 8K spiral (cut off)", f, p, flags, cfg, n_split)
            require(int(flk[1, 1]) == 1 and int(flk[1, 0]) >= cfg.max_hysteresis_iters,
                    f"8K spiral was not cut off: {flk.tolist()}")
            if n_split == 2:
                spiral_plain, spiral_flags = unpack_plain(fk, h), flk
                self.plain_ms["split_converge"] = plain_s * 1e3
        # (b) a scene that escalates and converges: lower scan_after until it does.
        cfg_b = None
        for sa in (8, 4, 2, 1):
            c = dataclasses.replace(cfg, hysteresis_scan_after=sa)
            fb, pb, flb = phase1(scene, c)
            if int(flb[0, 1]) == 1:
                cfg_b = c
                break
        require(cfg_b is not None, "no scan_after makes the 8K scene escalate")
        for n_split in (2, 4):
            _, flk, _ = both(f"8K scene 0, scan_after {cfg_b.hysteresis_scan_after} (converges)",
                             fb, pb, flb, cfg_b, n_split)
            require(int(flk[1, 1]) == 0, f"8K scene did not converge: {flk.tolist()}")

        # The engine: 'split' equals the default engine on the converged frame
        # and the plain split route on the spiral; four launches whatever the cap.
        expect = dict(ff_pack=1, hyst_phase1=1, split_converge=1, unpack=1, hyst_phase2=0,
                      unpack_core=0)
        eng_b = CannyEngine(dataclasses.replace(cfg_b, continuation="split"), device="cuda")
        eng_b.process(scene)
        got = self.path("process HYSTER 8K scene, continuation='split'",
                        lambda: eng_b.process(scene), expect)
        require(torch.equal(got, CannyEngine(cfg_b, device="cuda").process(scene)),
                "continuation='split' differs from the default engine on a converged frame")
        self.eng8_split = CannyEngine(dataclasses.replace(cfg, continuation="split"), device="cuda")
        self.eng8_split.process(spiral)
        got = self.path("process HYSTER 8K spiral, continuation='split'",
                        lambda: self.eng8_split.process(spiral), expect)
        require(torch.equal(got, spiral_plain), "continuation='split' differs from the plain split")
        eng400 = CannyEngine(dataclasses.replace(cfg, continuation="split",
                                                 max_hysteresis_iters=400), device="cuda")
        eng400.process(scene)
        self.path("process HYSTER 8K scene, continuation='split', cap 400",
                  lambda: eng400.process(scene), expect)
        print("continuation='split': == default engine on the converged 8K frame, == plain split "
              "on the spiral; 4 launches a call at cap 100 and cap 400")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self.eng8_split.process(spiral)
            eng_b.process(scene)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("process() with continuation='split': no host sync under set_sync_debug_mode('error')")

        # Times: the kernel alone on the spiral's phase-1 exit, then 8K
        # ms/frame of 'split' against 'kernel' on the cap-class and a calm frame.
        kw = dict(dilate_steps=cfg.hysteresis_inner_steps, scan_after=0,
                  max_iters=cfg.max_hysteresis_iters, chunk=SPLIT_CHUNK)
        self.ms["split_converge"] = self.time_ms(
            lambda s: converge_packed_split(s[0], p, s[1], h, 2, **kw), 1, reps=3,
            setup=lambda: (f.clone(), flags.clone()))
        seams = self.seam_rounds(f, p, flags, h, 2, kw)
        self.set_bound("split_converge", *split_work(h, w, 2, [seams], cfg.hysteresis_inner_steps))
        print(f"time split_converge: kernel {self.ms['split_converge']!r} ms, plain "
              f"{self.plain_ms['split_converge']!r} ms, bound {self.bound['split_converge'][0]!r} ms "
              f"({self.bound['split_converge'][1]}) (8K spiral from round {int(flags[0, 0])}: "
              f"{sum(seams)} rounds in {len(seams)} seam rounds {seams}, n_split 2; layout "
              f"{json.dumps(split_layout(1, h, w, 2, cfg.hysteresis_inner_steps))})")
        self.split_batches()
        eng8 = CannyEngine(cfg, device="cuda")
        for label, frame, reps in (("cap-class spiral", spiral, 3), ("calm scene 0", scene, 7)):
            t_split = self.time_ms(lambda _: self.eng8_split.process(frame), 1, reps=reps)
            t_kernel = self.time_ms(lambda _: eng8.process(frame), 1, reps=reps)
            t_split2 = self.time_ms(lambda _: self.eng8_split.process(frame), 1, reps=reps)
            print(f"time 8K {label}: continuation='split' {t_split!r} / {t_split2!r} ms/frame, "
                  f"'kernel' (K2) {t_kernel!r} ms/frame (medians of {reps}, split, kernel, split)")

    def seam_rounds(self, f, p, flags, h, n_split, kw) -> list:
        """The inner rounds of each seam round of one frame's split call from
        (f, flags): the seam rounds run one launch each (a budget of one
        more round ends the loop after one seam round, whose inner cap is
        the chunk all the same), the planes left as they were."""
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import converge_packed_split

        fs, it, changed, out = f.clone(), int(flags[0, 0]), int(flags[0, 1]), []
        while changed and it < kw["max_iters"]:
            fl = self.torch.tensor([[it, 1], [0, 0]], dtype=self.torch.int32, device=self.dev)
            converge_packed_split(fs, p, fl, h, n_split, **dict(kw, max_iters=it + 1))
            nxt, changed = (int(v) for v in fl[1])
            out.append(nxt - it)
            it = nxt
        return out

    def split_batches(self) -> None:
        """The batched K11 (``converge_packed_split_batched``): one launch for
        a batch against its plain version frame by frame and against a call
        a frame, on x8 1080p (7 scenes and the spiral) and x2 8K (scene 0 and
        the spiral) at their phase-1 exit, cap 100; the engine's launches
        under ``split`` for B = 1, 2 and 8; the times."""
        torch = self.torch
        import numpy as np
        from cudacam_tpu_torch import CannyConfig
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame
        from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            converge_packed_split, converge_packed_split_batched,
            converge_packed_split_batched_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            SPLIT_CHUNK, canny_mega_batched, split_count, split_layout,
        )

        cases = (("x8 1080p (7 scenes + spiral)", (1080, 1920),
                  lambda: [make_scene(1080, 1920, seed=s) for s in range(7)]
                  + [make_spiral_frame(1080, 1920)]),
                 ("x2 8K (scene 0 + spiral)", (4320, 7680),
                  lambda: [make_scene(4320, 7680, seed=0), make_spiral_frame(4320, 7680)]))
        for label, (h, w), frames in cases:
            cfg = CannyConfig(height=h, width=w, continuation="split")
            eng = CannyEngine(cfg, device="cuda")
            x = torch.from_numpy(np.stack(frames())).to(self.dev)
            f, p, flags = canny_mega_batched(x, eng._thresholds(), **pipeline_kwargs(cfg))
            n, ds = split_count(h, w), cfg.hysteresis_inner_steps
            kw = dict(dilate_steps=ds, scan_after=0, max_iters=cfg.max_hysteresis_iters,
                      chunk=SPLIT_CHUNK)
            fk, flk, fp, flp = f.clone(), flags.clone(), f.clone(), flags.clone()
            self.path(f"converge_packed_split_batched {label}",
                      lambda: converge_packed_split_batched(fk, p, flk, h, n, **kw),
                      dict(split_converge=1))
            t0 = time.perf_counter()
            converge_packed_split_batched_plain(fp, p, flp, h, n, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            self.diff("split_converge", fk, fp)
            self.diff("split_converge", flk, flp)
            grew = [b for b in range(len(x)) if int(flags[b, 0, 1])]
            require(grew and any(int(flk[b, 1, 1]) for b in grew),
                    f"{label}: no frame cut off by the cap: {flk.tolist()}")
            seams = [self.seam_rounds(f[b], p[b], flags[b], h, n, kw) for b in grew]
            fresh = lambda: (f.clone(), flags.clone())  # noqa: E731
            ms = self.time_ms(lambda s: converge_packed_split_batched(s[0], p, s[1], h, n, **kw),
                              1, reps=5, setup=fresh)
            ms_single = self.time_ms(
                lambda s: [converge_packed_split(s[0][b], p[b], s[1][b], h, n, **kw)
                           for b in range(len(x))], 1, reps=5, setup=fresh)
            t_ms, kind = bound_ms(*split_work(h, w, n, seams, ds))
            eng.process(x)
            batch_ms = self.time_ms(lambda _: eng.process(x), 1, reps=5)
            single_ms = self.time_ms(lambda _: [eng.process(fr) for fr in x], 1, reps=5)
            print(f"split_converge batched == plain on {label}, n_split {n}: final flags "
                  f"{flk[:, 1].tolist()}, growing at phase 1 {grew}, seam rounds {seams}; layout "
                  f"{json.dumps(split_layout(len(x), h, w, n, ds))}")
            print(f"time split_converge batched {label}: kernel {ms!r} ms (one launch) against "
                  f"{ms_single!r} ms in {len(x)} single calls, plain {plain_ms!r} ms, bound "
                  f"{t_ms!r} ms ({kind}); the engine's batch {batch_ms!r} ms against {single_ms!r} "
                  f"ms in single calls")
        # A continuation='split' call is four launches for any B.
        cfg = CannyConfig(height=1080, width=1920, continuation="split")
        eng = CannyEngine(cfg, device="cuda")
        scenes = [make_spiral_frame(1080, 1920)] + [make_scene(1080, 1920, seed=s)
                                                    for s in range(7)]
        expect = dict(ff_pack=1, hyst_phase1=1, split_converge=1, unpack=1, hyst_phase2=0)
        for nb in (1, 2, 8):
            x = torch.from_numpy(np.stack(scenes[:nb])).to(self.dev)
            eng.process(x)
            got = self.path(f"process HYSTER x{nb} 1080p, continuation='split'",
                            lambda: eng.process(x), expect)
            for b in range(nb):
                require(torch.equal(got[b], eng.process(x[b])),
                        f"x{nb} split batch differs from the single call on frame {b}")
        print("continuation='split' on x1, x2, x8 1080p batches: 4 launches a call, each frame "
              "equal to its single call")

    def phase_legacy(self) -> None:
        """K12: ``hyst_sweeps`` against its plain version and against the
        fused hysteresis (K6) at 1080p, then timed at 1080p, 4K and 8K
        (scene 0, equal to K6 there) with µs a promotion step."""
        torch = self.torch
        from cudacam_tpu_torch import CannyConfig, CannyStage
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.io.sources import make_scene, make_spiral_thresh
        from cudacam_tpu_torch.ops.cuda import hysteresis_sweeps, hysteresis_sweeps_plain
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs
        from cudacam_tpu_torch.ops.cuda.feedforward import ff_stages
        from cudacam_tpu_torch.ops.cuda.hysteresis import DEFAULT_BLOCK_H, HALO, sweeps_layout
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import hysteresis_fused

        h, w = 1080, 1920
        (tmap,) = ff_stages(self.frames[0], self.eng._thresholds(), (CannyStage.THRESH,))
        k6 = hysteresis_fused(tmap, **hyster_kwargs(self.cfg))
        for block_h, rc in ((DEFAULT_BLOCK_H, True), (64, False)):
            kw = dict(block_h=block_h, remove_candidates=rc, return_info=True)
            got, info = self.path(f"hysteresis_sweeps 1080p scene 0, block_h {block_h}",
                                  lambda: hysteresis_sweeps(tmap, **kw), dict(hyst_sweeps=3))
            t0 = time.perf_counter()
            want, winfo = hysteresis_sweeps_plain(tmap, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            self.diff("hyst_sweeps", got, want)
            self.diff("hyst_sweeps", info[:2], winfo[:2])
            require(int(info[1]) == 0, f"scene 0 did not converge: {info.tolist()}")
            require(torch.equal(torch.where(got == 255, got, torch.zeros_like(got)), k6),
                    "hyst_sweeps differs from the fused hysteresis (K6) on a converged map")
            print(f"hyst_sweeps == plain == K6 on 1080p scene 0, block_h {block_h}: "
                  f"{info.tolist()} [sweeps, changed, steps] (plain took {plain_s:.2f} s)")
            if block_h == DEFAULT_BLOCK_H:
                self.plain_ms["hyst_sweeps"], steps = plain_s * 1e3, int(info[2])
        spiral_t = torch.from_numpy(make_spiral_thresh(h, w)).to(self.dev)
        kw = dict(max_iters=2, block_h=128, max_local_iters=512, return_info=True)
        got, info = hysteresis_sweeps(spiral_t, **kw)
        want, winfo = hysteresis_sweeps_plain(spiral_t, **kw)
        self.diff("hyst_sweeps", got, want)
        self.diff("hyst_sweeps", info[:2], winfo[:2])
        require(info[:2].tolist() == [4, 1], f"the spiral was not cut off: {info.tolist()}")
        print(f"hyst_sweeps == plain on the 1080p spiral cut off (max_iters 2, block_h 128, "
              f"max_local_iters 512): {int((got == 255).sum())} finals, {info.tolist()}")

        self.ms["hyst_sweeps"] = self.time_ms(lambda _: hysteresis_sweeps(tmap), 3)
        k6_ms = self.time_ms(lambda _: hysteresis_fused(tmap, **hyster_kwargs(self.cfg)), 20)
        window_words = -(-(DEFAULT_BLOCK_H + 2 * HALO) // 32) * w
        self.set_bound("hyst_sweeps", 2 * h * w, SWEEP_STEP_OPS * steps * window_words)
        lay = sweeps_layout(h, w)
        print(f"time hyst_sweeps: kernel {self.ms['hyst_sweeps']!r} ms, plain "
              f"{self.plain_ms['hyst_sweeps']!r} ms, bound {self.bound['hyst_sweeps'][0]!r} ms "
              f"({self.bound['hyst_sweeps'][1]}); K6 on the same map {k6_ms!r} ms (1080p scene 0, "
              f"block_h {DEFAULT_BLOCK_H}, {steps} promotion steps, "
              f"{self.ms['hyst_sweeps'] * 1e3 / steps!r} us a step; {lay.cols} columns a thread "
              f"over {lay.threads} threads)")
        for name, (hh, ww) in (("4K", (2160, 3840)), ("8K", (4320, 7680))):
            eng = CannyEngine(CannyConfig(height=hh, width=ww), device="cuda")
            frame = torch.from_numpy(make_scene(hh, ww, seed=0)).to(self.dev)
            (big,) = ff_stages(frame, eng._thresholds(), (CannyStage.THRESH,))
            out, info = hysteresis_sweeps(big, return_info=True)
            require(int(info[1]) == 0 and torch.equal(out, hysteresis_fused(
                big, **hyster_kwargs(eng.config))), f"hyst_sweeps differs from K6 at {name}")
            ms = self.time_ms(lambda _: hysteresis_sweeps(big), 2, reps=3)
            sweeps, _, n_steps = info.tolist()
            lay = sweeps_layout(hh, ww)
            print(f"time hyst_sweeps {name} scene 0, block_h {DEFAULT_BLOCK_H}: {ms!r} ms, "
                  f"{sweeps} sweeps, {sweeps * -(-hh // DEFAULT_BLOCK_H)} windows, {n_steps} steps, "
                  f"{ms * 1e3 / n_steps!r} us a step (== K6; {lay.cols} columns a thread over "
                  f"{lay.threads} threads)")
            del eng, frame, big, out

    def phase_probes(self) -> None:
        """K13 and K14: the port's probe tools' runs as paths (counts set to
        0 just before, read just after), every probe kernel against its
        plain version at the TPU probes' shapes and at larger ones
        (tolerance 0): the packs also at widths 7696, 1918 and 53, at 4321 x
        7680, 33 x 1024 and 1 x 1, and on an 8K mask 1, 4 and 8 bytes past a
        16-byte boundary, each shape's ``probe_pack_layout`` required to
        name the route it must take, the loop on both routes
        (the probe's plane, the tallest 256-column plane the resident route
        takes, and one word row more), with each plane's
        ``probe_loop_layout`` and the ballot pack's grid; the unpack's byte
        mode and ``swar_stencil`` on both routes (widths off 16 and 8,
        inputs one element off a 16-byte boundary), each plane's layout
        required to name the route it must take; B/C/D's (326, 0);
        then the timings: one grid.sync()
        against the grid size, the unpack a thread per word against the
        byte mode on an 8K plane, the four stencil bodies in both modes at
        1080p, and P4 in SWAR against its int32 mode at 1080p and 8K."""
        torch = self.torch
        from cudacam_tpu_torch.probes import hyster_kernel as hk
        from cudacam_tpu_torch.probes import i16_swar as sw

        dev = self.dev
        rows = self.path("K13 probes (tools/port_kernel_probe.py's run)",
                         lambda: hk.run_probes(dev),
                         dict(probe_pack=1, probe_pack_ballot=1, probe_loop=1, probe_unpack=2))
        rows += self.path("K14 probe (tools/port_i16_probe.py's run)",
                          lambda: sw.run_probes(dev), dict(swar_stencil=8))
        for name, ok, detail in rows:
            print(f"  {name}: {'OK' if ok else 'MISMATCH'} {detail}")
        require(all(ok for _, ok, _ in rows), "a probe failed")

        h8, w8 = 4320, 7680

        def at_offset(x, offset: int):
            """A contiguous copy of ``x`` whose first byte lies ``offset``
            bytes past a 16-byte boundary (a slice of a larger buffer)."""
            esz = x.element_size()
            buf = torch.zeros(x.numel() + (16 + offset) // esz, dtype=x.dtype, device=dev)
            base = (-buf.data_ptr() % 16) // esz + offset // esz
            view = buf[base:base + x.numel()].view(x.shape)
            view.copy_(x)
            require(view.data_ptr() % 16 == offset and view.is_contiguous(),
                    f"a view {offset} bytes off a boundary")
            return view

        # The packs: the vector route at w % 16 == 0 (h off 32 too), the
        # general one at odd widths and on the 8K mask 1, 4 and 8 bytes off
        # a 16-byte boundary (aligned words cut by a funnel shift; words).
        for h, w, offset in ((*hk.PACK_SHAPE, 0), (h8, w8, 0), (h8, w8 + 16, 0), (1080, 1918, 0),
                             (70, 53, 0), (4321, w8, 0), (33, 1024, 0), (1, 1, 0), (h8, w8, 1),
                             (h8, w8, 4), (h8, w8, 8)):
            mask = torch.from_numpy(hk.pack_input(0, h, w)).to(dev)
            mask = at_offset(mask, offset) if offset else mask
            lay = hk.probe_pack_layout_cc(h, w, mask.data_ptr() % 16)
            route = "vector" if w % 16 == 0 and offset == 0 else "general"
            require(lay == hk.probe_pack_layout(h, w, offset) and lay["route"] == route,
                    f"probe_pack layout at {h}x{w}, offset {offset}: {lay}")
            print(f"probe_pack_layout {h}x{w} mask {offset} bytes off a boundary: "
                  f"{json.dumps(lay)}")
            want = hk.probe_pack_plain(mask)
            self.diff("probe_pack", hk.probe_pack(mask), want)
            self.diff("probe_pack_ballot", hk.probe_pack_ballot(mask), want)
            if offset == 0:
                print(f"probe_pack_ballot grid {h}x{w}: "
                      f"{json.dumps(hk.probe_pack_ballot_grid(h, w, dev.index))}")
            del mask
        # The unpack's byte mode: the probe's words and 8K (every row on a
        # 16-byte boundary), odd widths (heads and tails), words one word
        # off a boundary (the run's words loaded one by one).
        for hw, w in (hk.UNPACK_WORDS, (h8 // 32, w8), (1, 1), (2, 53), (3, 513)):
            f = torch.from_numpy(hk.unpack_input(2, hw, w)).to(dev)
            want = hk.probe_unpack_plain(f)
            lays = {mode: hk.probe_unpack_layout_cc(hw, w, mode) for mode in (True, False)}
            require(all(lay == hk.probe_unpack_layout(hw, w, mode) for mode, lay in lays.items())
                    and (lays[True]["route"], lays[False]["route"]) == ("word", "runs"),
                    f"probe_unpack layout at {hw}x{w}: {lays}")
            print(f"probe_unpack_layout {hw}x{w} words: a thread per word "
                  f"{json.dumps(lays[True])}, byte mode {json.dumps(lays[False])}")
            for offset in (0, 4):
                fv = at_offset(f, offset) if offset else f
                for per_word in (True, False):
                    self.diff("probe_unpack", hk.probe_unpack(fv, per_word), want)
        # The probe's 40 x 256 plane is the tallest 256-column plane the
        # resident route takes (every thread of a 1024-thread block at 10
        # rows); one word row more takes the grid route.
        past = (hk.LOOP_SHAPE[0] + 1, hk.LOOP_SHAPE[1])
        for shape, cap in ((hk.LOOP_SHAPE, hk.LOOP_ROUNDS), ((h8 // 32, w8), 40),
                           (past, hk.LOOP_ROUNDS)):
            lay = hk.probe_loop_layout(*shape, dev.index)
            print(f"probe_loop_layout {shape[0]}x{shape[1]}: {json.dumps(lay)}")
            require(lay["route"] == ("resident" if shape == hk.LOOP_SHAPE else "grid"),
                    f"probe_loop route at {shape}")
            if shape == hk.LOOP_SHAPE:
                require((lay["threads"], lay["words_per_thread"]) == (1024, 10),
                        f"probe_loop layout at {shape}: {lay}")
            plane = torch.from_numpy(hk.loop_input(*shape)).to(dev)
            got, flags = hk.probe_loop(plane, cap)
            want, want_flags = hk.probe_loop_plain(plane, cap)
            self.diff("probe_loop", got, want)
            self.diff("probe_loop", flags, want_flags)
            if shape == hk.LOOP_SHAPE:
                require(flags.tolist() == [[326, 0]], f"B/C/D flags {flags.tolist()}")
        # K14: the vector route at W % 8 == 0 on aligned planes, the general
        # route at odd widths and on the same planes one element off a
        # 16-byte boundary (2 bytes for int16, 1 for u8).
        for (h, w) in (sw.SHAPE, (1080, 1920), (h8, w8), (1, 1), (7, 9), (3, 513)):
            xi16, xu8 = (torch.from_numpy(a).to(dev) for a in sw.probe_inputs(h, w))
            for off in ((0, 1) if w % 8 == 0 else (0,)):
                lays = []
                for body in sw.BODIES:
                    x = xu8 if body == 4 else xi16
                    offset = off * x.element_size()
                    lay = sw.swar_layout_cc(h, w, body, offset)
                    route = "vector" if w % 8 == 0 and offset == 0 else "general"
                    require(lay == sw.swar_layout(h, w, body, offset) and lay["route"] == route,
                            f"swar_layout {h}x{w} P{body} at offset {offset}: {lay}")
                    lays.append(lay)
                    xv = at_offset(x, offset) if offset else x
                    want = sw.swar_stencil_plain(x, body)
                    for swar in (True, False):
                        self.diff("swar_stencil", sw.swar_stencil(xv, body, swar), want)
                print(f"swar_layout {h}x{w}, input one element off a boundary: {bool(off)}: "
                      + ", ".join(f"P{b} {json.dumps(lay)}" for b, lay in zip(sw.BODIES, lays)))
        print("probe_pack, probe_pack_ballot, probe_unpack (both modes), probe_loop and "
              "swar_stencil (P1-P4, both modes) == plain at the TPU probes' shapes and at 8K "
              "(the packs also at 8Kx7696, 1080x1918, 70x53, 4321x7680, 33x1024, 1x1 and 1, "
              "4 and 8 bytes off a 16-byte boundary, each probe_pack layout its route; "
              f"the loop at {past[0]}x{past[1]} (grid); the unpack also at 1x1, "
              "2x53, 3x513 words and one word off a boundary; swar_stencil at 1080p, 1x1, "
              "7x9, 3x513 and one element off a boundary too); "
              "B/C/D (rounds, changed) = (326, 0)")

        # Times, each beside its bound and its plain version.
        mask = torch.from_numpy(hk.pack_input(0, h8, w8)).to(dev)
        words = (h8 // 32) * w8
        for name, fn in (("probe_pack", hk.probe_pack), ("probe_pack_ballot", hk.probe_pack_ballot)):
            self.ms[name] = self.time_ms(lambda _: fn(mask), 20)
            self.plain_ms[name] = self.time_ms(lambda _: hk.probe_pack_plain(mask), 3)
            self.set_bound(name, h8 * w8 + 4 * words, 3 * h8 * w8)
        shifted = at_offset(mask, 1)  # probe_pack's general route, words cut by a funnel shift
        general_ms = self.time_ms(lambda _: hk.probe_pack(shifted), 20)
        del shifted
        f8 = torch.from_numpy(hk.unpack_input(2, h8 // 32, w8)).to(dev)
        self.ms["probe_unpack"] = self.time_ms(lambda _: hk.probe_unpack(f8, True), 20)
        byte_ms = self.time_ms(lambda _: hk.probe_unpack(f8, False), 20)
        self.plain_ms["probe_unpack"] = self.time_ms(lambda _: hk.probe_unpack_plain(f8), 3)
        self.set_bound("probe_unpack", 4 * words + h8 * w8, 2 * h8 * w8)
        loop_plane = torch.from_numpy(hk.loop_input()).to(dev)
        self.ms["probe_loop"] = self.time_ms(lambda _: hk.probe_loop(loop_plane), 5)
        self.plain_ms["probe_loop"] = self.time_ms(lambda _: hk.probe_loop_plain(loop_plane), 1,
                                                   reps=3)
        lw = loop_plane.numel()
        self.set_bound("probe_loop", 2 * 4 * lw, 326 * 6 * lw)  # 326 rounds: 3 ORs, a shift, a compare, a store
        x16, x8 = (torch.from_numpy(a).to(dev) for a in sw.probe_inputs(1080, 1920))
        self.ms["swar_stencil"] = self.time_ms(lambda _: sw.swar_stencil(x8, 4, True), 50)
        self.plain_ms["swar_stencil"] = self.time_ms(lambda _: sw.swar_stencil_plain(x8, 4), 5)
        self.set_bound("swar_stencil", 1080 * 1920 * (1 + 4), 5 * 1080 * 1920)
        # The library yardstick: one 3x3 circular convolution in float32 (exact
        # here: every value < 2^24, TF32 off) on the same plane, converted
        # outside the timing.
        conv = torch.nn.Conv2d(1, 1, 3, padding=1, padding_mode="circular", bias=False).to(dev)
        with torch.no_grad():
            conv.weight.copy_(torch.tensor([[1.0, 2.0, 1.0]] * 3, device=dev)[None, None])
            xf = x8.float()[None, None]
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                lib_out = conv(xf)[0, 0].to(torch.int32)
                require(torch.equal(lib_out, sw.swar_stencil_plain(x8, 4)),
                        "the circular convolution is not P4")
                self.library_ms["swar_stencil"] = self.time_ms(lambda _: conv(xf), 50)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
        for name, where in (("probe_pack", "8K mask"), ("probe_pack_ballot", "8K mask"),
                            ("probe_unpack", "135x7680 words, a thread per word"),
                            ("probe_loop", "40x256 plane, 326 rounds"),
                            ("swar_stencil", "P4 SWAR at 1080p")):
            print(f"time {name}: kernel {self.ms[name]!r} ms, plain {self.plain_ms[name]!r} ms, "
                  f"bound {self.bound[name][0]!r} ms ({self.bound[name][1]}) ({where})")
        print(f"time probe_pack 8K mask one byte off a boundary (the general route): "
              f"{general_ms!r} ms (aligned: {self.ms['probe_pack']!r} ms)")
        print(f"time probe_unpack 135x7680 words: a thread per word {self.ms['probe_unpack']!r} "
              f"ms, the byte mode (a thread per 16-byte run of a row) {byte_ms!r} ms")
        print(f"time swar_stencil P4 1080p: library (circular conv2d, float32) "
              f"{self.library_ms['swar_stencil']!r} ms")
        body_ops = {1: 4, 2: 2, 3: 4, 4: 5}  # adds and multiplies a pixel
        for body, label in sw.BODIES.items():
            x = x8 if body == 4 else x16
            t = [self.time_ms(lambda _, s=s: sw.swar_stencil(x, body, s), 50) for s in (True, False)]
            bound, binds = bound_ms(1080 * 1920 * (x.element_size() + 4), body_ops[body] * 1080 * 1920)
            print(f"time swar_stencil {label} 1080p: SWAR {t[0]!r} ms, int32 mode {t[1]!r} ms, "
                  f"bound {bound!r} ms ({binds})")
        for label, (h, w) in (("1080p", (1080, 1920)), ("8K", (h8, w8))):
            xu8 = torch.from_numpy(sw.probe_inputs(h, w)[1]).to(dev)
            t = [self.time_ms(lambda _, s=s: sw.swar_stencil(xu8, 4, s), 50)
                 for s in (True, False, False, True)]
            print(f"time swar_stencil P4 {label}: SWAR {t[0]!r} / {t[3]!r} ms, int32 mode "
                  f"{t[1]!r} / {t[2]!r} ms (SWAR, int32, int32, SWAR)")
        for blocks, us in hk.grid_sync_us(dev):
            print(f"time grid.sync() at {blocks} blocks: {us!r} us a barrier (1000 in one "
                  f"launch, median of 5)")

    def phase_app(self) -> None:
        """The live app on the card."""
        torch = self.torch
        import numpy as np
        from cudacam_tpu_torch import CannyConfig, CannyStage
        from cudacam_tpu_torch.app import CannyApp
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.io import SequenceSource, SyntheticSource, open_source, to_host
        from cudacam_tpu_torch.io.compose import compose
        from cudacam_tpu_torch.ops import cuda as kernels
        from cudacam_tpu_torch.ops.cuda import _build
        from cudacam_tpu_torch.utils import devtime
        from cudacam_tpu_torch.utils.debug import device_health_check

        h, w = 1080, 1920
        main = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack")
        require(device_health_check() == "cuda", "device_health_check")
        ref = CannyEngine(CannyConfig(height=h, width=w), device="cuda")

        def check(app, n, stage=CannyStage.HYSTER, expect=None):
            """``n`` frames through ``app.run``; every output against
            ``ref.process`` of the same raw frame at the app's thresholds."""
            seen = []
            ref.set_high_threshold(255)
            ref.set_low_threshold(app.engine.get_low_threshold())
            ref.set_high_threshold(app.engine.get_high_threshold())
            run = lambda: app.run(n, on_frame=lambda i, o: seen.append((app._last_input, o)))  # noqa: E731
            done = run() if expect is None else self.path(f"app, {n} x {stage.name}", run, expect)
            require(done == n and len(seen) == n, f"app ran {done} of {n} frames")
            for i, (raw, out) in enumerate(seen):
                require(isinstance(out, torch.Tensor) and out.is_cuda, "app output is not on the card")
                require(torch.equal(out, ref.process(raw, stage)),
                        f"app frame {i} at {stage.name} differs from CannyEngine.process")

        scenes = np.stack([to_host(f) for f in self.frames[:8]])
        with CannyApp(SyntheticSource(height=h, width=w, n_frames=64), ring_capacity=8) as app:
            app.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(app, 64, expect=dict.fromkeys(main, 64))
            synth_ms = (time.perf_counter() - t0) * 1e3 / 64  # with the 64 reference calls
            require(all(isinstance(t, torch.Tensor) and t.is_cuda for t in app.ring.history())
                    and len(app.ring) == 8, "the ring does not hold 8 CUDA tensors")
            print("app: 64 x 1080p BGR frames of a SyntheticSource through run() == "
                  f"CannyEngine.process; the ring holds 8 CUDA tensors ({synth_ms!r} ms/frame, "
                  "the source drawing each scene on the host)")
        # Live controls on a running stream (a looped sequence of the eight
        # scenes: a free source).
        with CannyApp(SequenceSource.from_array(scenes, loop=True), ring_capacity=8) as app:
            app.warmup()
            check(app, 8, expect=dict.fromkeys(main, 8))
            # Live controls on the running stream: nothing is built.
            loads = _build.load.cache_info().misses
            app.apply_controls(low=20, high=80)
            check(app, 3, expect=dict.fromkeys(main, 3))
            for _ in CannyStage:
                stage = app.cycle_stage()
                expect = (dict.fromkeys(main, 2) if stage == CannyStage.HYSTER
                          else dict(ff_stages=2, ff_pack=0))
                check(app, 2, stage, expect)
            require(app.stage == CannyStage.HYSTER, f"stage cycle ended at {app.stage.name}")
            app.apply_controls(pipeline=False)
            out = self.path("app, pipeline off", app.step, dict.fromkeys(main + ("ff_stages",), 0))
            require(out.is_cuda and torch.equal(out.cpu(), torch.from_numpy(app._last_input)),
                    "pass-through is not the raw frame on the card")
            app.engine.timers.reset()
            app.apply_controls(pipeline=True, profiling=True)
            check(app, 3)
            table = app.profiling_table()
            rows = {n: app.engine.timers.get_average_time(n) for n, _, _ in app.engine.timers.items()}
            require(app.engine._profiling_mode_resolved() == "device" and len(rows) == 6
                    and all(v > 0.0 for v in rows.values()),
                    f"profiling table: a stage reads no time:\n{table}")
            app.apply_controls(profiling=False, low=10, high=40)
            check(app, 2, expect=dict.fromkeys(main, 2))
            require(_build.load.cache_info().misses == loads, "a live control built or loaded something")
            json.dumps(app.status())
            print("app: thresholds, a stage cycle through all six, pipeline off/on, profiling "
                  "on/off mid-stream == CannyEngine.process, nothing built; profiling table "
                  f"(mode {app.engine._profiling_mode_resolved()}: kernel busy time, every row "
                  f"> 0; profiler sessions refused as not whole in this process so far: "
                  f"{devtime.refused_sessions}):\n{table}")

        # Eight cameras: the batched kernels, one launch each a step.
        with CannyApp(open_source("multi:8*synthetic:1080x1920", n_frames=4)) as app:
            app.warmup()
            out = self.path("app, BatchSource of 8 x 1080p", app.step, dict.fromkeys(main, 1))
            raw = app._last_input
            require(tuple(out.shape) == (8, h, w) and raw.shape == (8, h, w, 3), "batch shapes")
            for b in range(8):
                require(torch.equal(out[b], ref.process(raw[b])), f"camera {b} differs")
            wall = compose(raw, to_host(out), "edges")
            require(wall.shape == (3 * h + 4, 3 * w + 4, 3), f"montage {wall.shape}")
            print(f"app: a BatchSource of 8 goes through the batched kernels (4 launches a "
                  f"step), == CannyEngine.process per camera; montage {wall.shape}")

        # ms/frame, wall clock to the last frame's end: host frames through the
        # pinned staging buffers, the device loop, the bare engine stream.
        def app_ms(source, n, loop=0):
            with CannyApp(source) as app:
                app.warmup()
                if loop:
                    app.preload_device_loop(loop)
                app.run(16)
                return statistics.median(self.wall_ms(lambda: app.run(n), n) for _ in range(5))

        host_ms = app_ms(SequenceSource.from_array(scenes, loop=True), 200)
        loop_ms = app_ms(SequenceSource.from_array(scenes, loop=True), 400, loop=8)
        dev_frames = self.frames[:8]
        eng_ms = statistics.median(
            self.wall_ms(lambda: [self.eng.process(f) for f in dev_frames * 50], 400) for _ in range(5))
        for label, ms in (("host frames, looped 8 scenes (pinned staging, non-blocking upload)", host_ms),
                          ("preload_device_loop(8)", loop_ms),
                          ("bare CannyEngine.process on 8 device frames", eng_ms)):
            print(f"time app 1080p BGR, {label}: {ms!r} ms/frame, {1e3 / ms!r} fps (wall clock, "
                  f"medians of 5 runs)")

    def phase_native(self) -> None:
        """The app on a ``.rawv`` through the native frame pump, uploading
        from its pinned slots."""
        torch = self.torch
        import tempfile

        import numpy as np
        from cudacam_tpu_torch import CannyConfig
        from cudacam_tpu_torch.app import CannyApp
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.io import SequenceSource, to_host
        from cudacam_tpu_torch.io.sources import FrameSource, RawvSource
        from cudacam_tpu_torch.native import FramePump, write_rawv
        from cudacam_tpu_torch.utils.devtime import SENTINELS
        from torch.profiler import ProfilerActivity, profile

        h, w, n = 1080, 1920, 64
        main = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack")
        scenes = [to_host(f) for f in self.frames[:8]]
        # 64 distinct frames: the eight scenes, each XOR-ed with its index.
        clip = np.stack([scenes[i % 8] ^ np.uint8(i) for i in range(n)])
        ref = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            path = write_rawv(f"{tmp}/clip.rawv", clip)
            with FramePump(path) as pump:
                got = [pump.read() for _ in range(3)]
            require(all(np.array_equal(a, clip[i]) for i, a in enumerate(got)),
                    "the pump's frames differ from the file's")
            with CannyApp(RawvSource(path)) as app:
                require(app._lends and app._source.pinned, "the app does not upload from pinned slots")
                app.warmup()
                outs, bad = [], []

                def check(i, out):  # the slot's frame; edge maps are held after the path
                    outs.append(out)
                    if not np.array_equal(app._last_input, clip[i]):
                        bad.append(i)

                done = self.path(f"app on a .rawv, {n} x 1080p BGR through the pump",
                                 lambda: app.run(None, on_frame=check), dict.fromkeys(main, n))
                bad += [i for i, out in enumerate(outs) if not torch.equal(out, ref.process(clip[i]))]
                require(done == n and not bad, f"app on the pump: {done} frames, frames {bad} differ")
            require(app._last_input.base is None and np.array_equal(app._last_input, clip[-1]),
                    "after close the app's raw frame is not an owned copy of the last frame")
            print(f"app on a {n}-frame 1080p BGR .rawv: uploads from the pump's pinned slots "
                  f"(ring_slots 4), every edge map == CannyEngine.process of its frame; after "
                  f"close the raw frame is an owned copy")

            def app_ms(source, k=192):
                with CannyApp(source) as app:
                    app.warmup()
                    app.run(16)
                    ms = statistics.median(self.wall_ms(lambda: app.run(k), k) for _ in range(5))
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        for _ in range(SENTINELS[0]):  # the records the profiler may drop
                            torch.cuda._sleep(1)
                        torch.cuda.synchronize()
                        app.run(16)
                        torch.cuda.synchronize()
                    htod = [e for e in prof.key_averages() if "Memcpy HtoD" in e.key]
                    k = sum(e.count for e in htod)
                    us = sum(e.self_device_time_total or e.device_time_total
                             for e in htod) / k if k else None
                    return ms, us, k, sorted(e.key for e in htod)

            class PumpCopies(FrameSource):
                """The pump's owned copies (``read()``): the app stages them."""

                def _open(self):
                    self._pump = FramePump(path, loop=True)

                def _next(self):
                    return self._pump.read()

                def _close(self):
                    self._pump.close()

            class PythonReader(FrameSource):
                """The looped file read in Python, a copy a frame: the reader
                the pump replaced; the app stages its frames."""

                def _open(self):
                    self._f = open(path, "rb")
                    self._shape = (h, w, 3)
                    self._f.seek(28)  # the header

                def _next(self):
                    buf = self._f.read(h * w * 3)
                    if not buf:
                        self._f.seek(28)
                        buf = self._f.read(h * w * 3)
                    return np.frombuffer(buf, np.uint8).reshape(self._shape).copy()

                def _close(self):
                    self._f.close()

            routes = {
                "a looped .rawv through the pump, uploads from its pinned slots":
                    lambda: RawvSource(path, loop=True),
                "the pump's read() (an owned copy) and the pinned staging copy":
                    PumpCopies,
                "the file read in Python (the reader the pump replaced) and the pinned staging copy":
                    PythonReader,
                "the same 64 frames as a looped list source and the pinned staging copy":
                    lambda: SequenceSource.from_array(clip, loop=True),
            }
            order = list(routes) + list(routes)[::-1]  # each route twice, in turns
            times = {label: [] for label in routes}
            for label in order:
                times[label].append(app_ms(routes[label]()))
            with FramePump(path, loop=True) as fp:  # the producer alone: lend, give back
                for _ in range(16):
                    fp.lend()
                    fp.give_back()
                t0 = time.perf_counter()
                for _ in range(192):
                    fp.lend()
                    fp.give_back()
                alone_ms = (time.perf_counter() - t0) * 1e3 / 192
        for label, runs in times.items():
            for ms, us, k, kinds in runs:
                print(f"time app 1080p BGR, {label}: {ms!r} ms/frame, {1e3 / ms!r} fps (wall "
                      f"clock, medians of 5 runs of 192 frames); Memcpy HtoD {us!r} us a copy "
                      f"({k} copies in 16 profiled frames: {kinds})")
        print(f"time the frame pump alone on the looped 1080p BGR .rawv (lend, give back; its "
              f"producer thread reading each frame into a slot): {alone_ms!r} ms/frame")

    def phase_bench(self) -> None:
        """``benchmark.main`` on the card: exactly one JSON line, the event
        clock on cuda."""
        import contextlib
        import io

        from cudacam_tpu_torch import benchmark
        from cudacam_tpu_torch.ops import cuda as kernels

        main = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack")
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                benchmark.main(device="cuda")

        self.path("bench main (1080p, 8 scenes)", run, {})
        counts = kernels.launch_counts()
        require(all(counts[k] > 0 for k in main), f"bench launched {counts}")
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        require(len(lines) == 1, f"bench printed {len(lines)} lines: {buf.getvalue()!r}")
        rec = json.loads(lines[0])
        require(set(rec) == {"metric", "value", "unit", "vs_baseline"}, f"bench keys {sorted(rec)}")
        require(rec["metric"] == "canny_1080p_event_ms_per_frame_cuda" and rec["value"] > 0,
                f"bench line {rec}")
        print(f"bench: {lines[0]}")

    def phase_parity(self) -> None:
        """Parity's card route against its CPU route, byte for byte."""
        import numpy as np
        from cudacam_tpu_torch import parity
        from cudacam_tpu_torch.io.sources import make_scene

        n = 0
        for h, w in ((288, 512), (540, 960)):
            for seed in (0, 1):
                frame = make_scene(h, w, seed=seed)
                for lo, hi in ((10, 40), (20, 60), (30, 90)):
                    # compare_frame's thresholds in each domain.
                    for domain, pair in (("reference", (lo, hi)), ("opencv", (2 * lo, 2 * hi))):
                        got = parity._our_canny(frame, *pair, domain, "cuda")
                        want = parity._our_canny(frame, *pair, domain, "cpu")
                        err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
                        require(got.shape == want.shape and err == 0,
                                f"parity {h}x{w} seed {seed} {domain} {pair}: card differs "
                                f"from CPU by {err}")
                        n += 1
        print(f"parity: the card route (CannyEngine) == the CPU route (torch_ops) on {n} maps "
              "(288x512 and 540x960, two scenes each, both domains, the gate's three pairs; "
              "max_abs_err 0)")

    def phase_no_sync(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyStage

        eng, frames = self.eng, self.frames[:8]
        lows, highs = sweep_pairs()
        calls = [lambda: [eng.process(f) for f in frames], lambda: eng.process(self.batch),
                 lambda: eng.process(frames[0], CannyStage.THRESH),
                 lambda: eng.process_all(frames[0]),
                 lambda: eng.threshold_sweep(frames[0], lows, highs)]
        for call in calls:
            call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for call in calls:
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("steady-state process() (single, x8 batch, THRESH), process_all() and "
              "threshold_sweep() (K=16): no host sync under set_sync_debug_mode('error')")

    def phase_timing(self) -> None:
        torch = self.torch
        from cudacam_tpu_torch import CannyStage
        from cudacam_tpu_torch.ops import bitpack, torch_ops
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs
        from cudacam_tpu_torch.ops.cuda.feedforward import (
            FF_STAGES, NMSQ, ff_pack, ff_pack_plain, ff_stages, ff_stages_plain,
        )
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            hysteresis_fused, pack_thresh, pack_thresh_plain,
        )
        from cudacam_tpu_torch.ops.cuda.megakernel import (
            hyst_phase1, hyst_phase2, unpack, unpack_plain,
        )
        from cudacam_tpu_torch.io.sources import make_spiral_thresh

        eng, cfg, frames = self.eng, self.cfg, self.frames[:8]
        thr = eng._thresholds()
        h, w = 1080, 1920
        rounds = dict(dilate_steps=16, max_iters=100)
        frame = frames[0]
        f0, p0 = ff_pack(frame, thr)
        flags0 = lambda: torch.zeros((2, 2), dtype=torch.int32, device=self.dev)  # noqa: E731

        self.ms["ff_pack"] = self.time_ms(lambda _: ff_pack(frame, thr), 50)
        self.plain_ms["ff_pack"] = self.time_ms(lambda _: ff_pack_plain(frame, thr), 5)
        # The 8-scene rotation: a frame is not still in L2 from the call before.
        rotation_ms = self.time_ms(lambda _: [ff_pack(x, thr) for x in frames], 6) / len(frames)
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

        self.ms["ff_stages"] = self.time_ms(lambda _: ff_stages(frame, thr, FF_STAGES), 50)
        self.plain_ms["ff_stages"] = self.time_ms(
            lambda _: ff_stages_plain(frame, thr, FF_STAGES), 5)
        # Every other timed mode of the two kernels, each with its own bound:
        # (label, kernel call, plain call, bytes, operations).
        gray = frame[..., 1].contiguous()
        th, gr = (CannyStage.THRESH,), (CannyStage.GRADIENT,)
        (tmap,) = ff_stages(frame, thr, th)
        (kg,) = ff_stages(frame, None, (NMSQ,))
        kb = thr * thr
        px, words = h * w, -(-h // 32) * w
        ks = cfg.kernel_size
        ops_sobel = 6 + 2 * ks * ks + 1 + 24  # mono, the Gaussian, the Sobel sums
        modes = [
            ("ff_stages four outputs, gray", lambda: ff_stages(gray, thr, FF_STAGES[1:]),
             lambda: ff_stages_plain(gray, thr, FF_STAGES[1:]), px + 4 * px, chain_ops(ks) * px),
            ("ff_stages THRESH alone", lambda: ff_stages(frame, thr, th),
             lambda: ff_stages_plain(frame, thr, th), 3 * px + px, chain_ops(ks) * px),
            ("ff_stages GRADIENT alone", lambda: ff_stages(frame, thr, gr),
             lambda: ff_stages_plain(frame, thr, gr), 3 * px + px, (ops_sobel + 12) * px),
            ("ff_stages NMSQ", lambda: ff_stages(frame, None, (NMSQ,)),
             lambda: ff_stages_plain(frame, None, (NMSQ,)), 3 * px + 4 * px,
             (chain_ops(ks) - 2) * px),
            ("pack_thresh nmsq", lambda: pack_thresh(kg, kb), lambda: pack_thresh_plain(kg, kb),
             4 * px + 2 * 4 * words, 4 * px),
        ]
        mode_times = [(label, self.time_ms(lambda _: run(), 50), self.time_ms(lambda _: plain(), 5),
                       nbytes, ops) for label, run, plain, nbytes, ops in modes]
        self.ms["pack_thresh"] = self.time_ms(lambda _: pack_thresh(tmap), 50)
        self.plain_ms["pack_thresh"] = self.time_ms(lambda _: pack_thresh_plain(tmap), 20)
        k6_kw = hyster_kwargs(cfg)
        k6_ms = self.time_ms(lambda _: hysteresis_fused(tmap, **k6_kw), 50)
        k6_plain_ms = self.time_ms(lambda _: bitpack.hysteresis_packed(tmap, **k6_kw), 1, reps=3)

        # Bounds of the timed calls, from these inputs: 1080p, the rounds each
        # call ran (flags), bytes read once and written once.
        ops_px = chain_ops(cfg.kernel_size)
        fl1 = flags0()
        hyst_phase1(f0.clone(), p0, fl1, h, scan_after=64, **rounds)
        fl2 = fl.clone()
        hyst_phase2(fs.clone(), ps, fl2, h, **rounds)
        r1, r2 = int(fl1[0, 0]), int(fl2[1, 0]) - int(fl2[0, 0])
        self.set_bound("ff_pack", 3 * px + 2 * 4 * words, ops_px * px)
        self.set_bound("hyst_phase1", 3 * 4 * words, r1 * round_ops(words, 16, False))
        self.set_bound("hyst_phase2", 3 * 4 * words, r2 * round_ops(words, 16, True))
        self.set_bound("unpack", 4 * words + px, 2 * px)
        self.set_bound("ff_stages", 3 * px + 5 * px, ops_px * px)
        self.set_bound("pack_thresh", px + 2 * 4 * words, 4 * px)
        print(f"bound inputs: hyst_phase1 {r1} rounds (scene 0), hyst_phase2 {r2} rounds (spiral)")
        from cudacam_tpu_torch.ops.cuda.megakernel import round_layout

        for label, (lh, lw), steps, nb in (("1080p", (1080, 1920), 16, 1), ("1080p x8", (1080, 1920), 16, 8),
                                           ("4K", (2160, 3840), 32, 1), ("8K", (4320, 7680), 16, 1)):
            for phase in (1, 2):
                print(f"round layout {label} phase {phase} ({steps} inner steps): "
                      f"{json.dumps(round_layout(nb, lh, lw, steps, phase))}")

        def stream(process, reps):
            return self.time_ms(lambda _: [process(f) for f in frames], 1, reps=reps) / len(frames)

        kernel_ms = stream(eng.process, 7)
        plain_ms = stream(lambda f: torch_ops.canny_to_stage(f, thr[0], thr[1], cfg, CannyStage.HYSTER), 5)
        batches = {}
        for label, batch in (("7 scenes + spiral", self.batch), ("8 scenes", torch.stack(frames))):
            batches[label] = (
                self.time_ms(lambda _: eng.process(batch), 1, reps=7) / len(batch),
                self.time_ms(lambda _: [eng.process(f) for f in batch], 1, reps=7) / len(batch),
            )
        stage_ms = stream(lambda f: eng.process(f, CannyStage.THRESH), 7)
        all_ms = stream(eng.process_all, 7)
        for name in self.ms:
            print(f"time {name}: kernel {self.ms[name]!r} ms, plain {self.plain_ms[name]!r} ms (1080p)")
        print(f"time ff_pack on the 8-scene rotation: {rotation_ms!r} ms a frame (scene 0 "
              f"again and again: {self.ms['ff_pack']!r})")
        print(f"time hyst_phase2 on a converged frame (returns at once): {noop_ms!r} ms")
        for label, ms, plain, nbytes, ops in mode_times:
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
            print(f"time {label}: kernel {ms!r} ms, plain {plain!r} ms, bound "
                  f"{max(t_bytes, t_ops) * 1e3!r} ms ({'bytes' if t_bytes >= t_ops else 'operations'}) "
                  f"(1080p)")
        print(f"time K6 whole (pack_thresh + rounds + unpack) on scene 0's threshold map "
              f"({k6_kw}): "
              f"kernels {k6_ms!r} ms, plain {k6_plain_ms!r} ms")
        print(f"time 1080p 8-scene stream: kernel path {kernel_ms!r} ms/frame (median of 7 "
              f"passes), plain path {plain_ms!r} ms/frame (median of 5), CUDA events, on {self.card}")
        for label, (batch_ms, singles_ms) in batches.items():
            print(f"time 1080p x8 batch ({label}): batched {batch_ms!r} ms/frame, "
                  f"8 single-frame calls {singles_ms!r} ms/frame (medians of 7)")
        # K3's bound: the x8 call with the spiral, its four kernels on the
        # rounds each frame ran (flags), frames read once and maps written once.
        from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs
        from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline_batched

        _, bfl = canny_mega_pipeline_batched(self.batch, thr, **pipeline_kwargs(cfg))
        nb = len(self.batch)
        k3_ops = nb * (ops_px * px + 2 * px) + sum(
            int(a) * round_ops(words, 16, False) + (int(b) - int(a)) * round_ops(words, 16, True)
            for a, b in zip(bfl[:, 0, 0].tolist(), bfl[:, 1, 0].tolist()))
        t_bytes, t_ops = nb * 4 * px / HBM_BYTES_PER_S, k3_ops / OPS_PER_S
        print(f"bound K3 x8 call (7 scenes + spiral): {max(t_bytes, t_ops) * 1e3!r} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) against "
              f"{batches['7 scenes + spiral'][0] * nb!r} ms a call (rounds {bfl.tolist()})")
        print(f"time 1080p process(frame, THRESH) {stage_ms!r} ms/frame, process_all "
              f"{all_ms!r} ms/frame (8 scenes, medians of 7)")

    def phase_sweep_timing(self) -> None:
        """``sweep_pack_all`` (every slot of a K=16 sweep) and ``sweep_seed``
        alone, the pack step of a sweep (one pack and K - 1 seeds) beside its
        bound, seeded against cold tails, and the K=16 sweeps through the
        engine at 1080p, 4K and 8K against the plain sweep (at 8K for K=2,
        the first and last pair)."""
        torch = self.torch
        from cudacam_tpu_torch import CannyConfig
        from cudacam_tpu_torch.engine import CannyEngine
        from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs, sweep_bounds
        from cudacam_tpu_torch.ops.cuda.feedforward import NMSQ, ff_stages
        from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
            sweep_fused, sweep_order, sweep_pack_all, sweep_pack_all_plain, sweep_seed,
            sweep_seed_plain,
        )
        from cudacam_tpu_torch.io.sources import make_scene

        lows, highs = sweep_pairs()
        k = len(lows)
        dev_pairs = lambda sel: [torch.from_numpy(x[sel]).to(self.dev) for x in (lows, highs)]  # noqa: E731
        cfg, frame = self.cfg, self.frames[0]
        (kg,) = ff_stages(frame, None, (NMSQ,))
        bounds = sweep_bounds(*dev_pairs(slice(None)), cfg)
        sorted_b = bounds.view(k, 2)[sweep_order(bounds).long()].reshape(-1)
        fk = torch.zeros((k, -(-1080 // 32), 1920), dtype=torch.int32, device=self.dev)
        pk = torch.zeros_like(fk)
        px, words = 1080 * 1920, -(-1080 // 32) * 1920
        self.ms["sweep_pack_all"] = self.time_ms(lambda _: sweep_pack_all(kg, sorted_b, fk, pk), 50)
        self.plain_ms["sweep_pack_all"] = self.time_ms(
            lambda _: sweep_pack_all_plain(kg, sorted_b, fk, pk), 5)
        self.set_bound("sweep_pack_all", 4 * px + 2 * k * 4 * words, 2 * k * px)  # kg, 2K planes
        self.ms["sweep_seed"] = self.time_ms(lambda _: sweep_seed(sorted_b, 1, fk), 50)
        self.plain_ms["sweep_seed"] = self.time_ms(lambda _: sweep_seed_plain(sorted_b, 1, fk), 20)
        pairs = sorted_b.clamp_min(0).view(k, 2).tolist()
        seeded = sum(a[0] >= b[0] and a[1] >= b[1] for a, b in zip(pairs, pairs[1:]))
        require(seeded > 0 and pairs[0][0] >= pairs[1][0] and pairs[0][1] >= pairs[1][1],
                f"the sweep's slot 1 is not seeded: {pairs}")
        self.set_bound("sweep_seed", 3 * 4 * words, words)  # two planes read, one written
        step_ms = self.time_ms(lambda _: (sweep_pack_all(kg, sorted_b, fk, pk), [
            sweep_seed(sorted_b, i, fk) for i in range(1, k)]), 20)
        step_bound = (4 * px + 2 * k * 4 * words + seeded * 4 * words) / HBM_BYTES_PER_S * 1e3
        print(f"time sweep_pack_all: kernel {self.ms['sweep_pack_all']!r} ms, plain "
              f"{self.plain_ms['sweep_pack_all']!r} ms (1080p, K={k}); sweep_seed: kernel "
              f"{self.ms['sweep_seed']!r} ms, plain {self.plain_ms['sweep_seed']!r} ms (slot 1, "
              f"seeded); the pack step of a K={k} sweep (1 pack + {k - 1} seeds): {step_ms!r} ms "
              f"against its bound {step_bound!r} ms (bytes: keep*g once, {2 * k} planes written, "
              f"{seeded} seed planes read)")
        tails = {seed: self.time_ms(
            lambda _: sweep_fused(kg, bounds, monotone_seed=seed, **hyster_kwargs(cfg)), 5, reps=7)
            for seed in (True, False)}
        print(f"time sweep_fused 1080p K=16 on scene 0's keep*g plane (medians of 7): seeded "
              f"{tails[True]!r} ms, cold tails {tails[False]!r} ms")

        for label, (h, w), n, plain_sel in (("1080p", (1080, 1920), 5, slice(None)),
                                            ("4K", (2160, 3840), 3, slice(None)),
                                            ("8K", (4320, 7680), 1, [0, -1])):
            cfg_s = CannyConfig(height=h, width=w)
            eng = CannyEngine(cfg_s, device="cuda")
            fr = torch.from_numpy(make_scene(h, w, seed=0)).to(self.dev)
            maps, counts = eng.threshold_sweep(fr, lows, highs)
            c = counts.tolist()
            require(maps.shape == (k, h, w) and c == sorted(c, reverse=True) and c[-1] > 0,
                    f"{label} sweep: {tuple(maps.shape)}, counts {c}")
            kernel_ms = self.time_ms(lambda _: eng.threshold_sweep(fr, lows, highs), n)
            sub, sub_np = dev_pairs(plain_sel), (lows[plain_sel], highs[plain_sel])
            plain = plain_sweep(fr, *sub, cfg_s)
            got = eng.threshold_sweep(fr, *sub_np)[0]
            self.sweep_diff(got, plain, True)
            plain_ms = self.time_ms(lambda _: plain_sweep(fr, *sub, cfg_s), 1,
                                    reps=3 if h == 1080 else 1)
            kp = len(plain)
            sub_ms = kernel_ms if kp == k else self.time_ms(
                lambda _: eng.threshold_sweep(fr, *sub_np), n)
            print(f"time threshold_sweep {label} K={k}: kernels {kernel_ms!r} ms (CUDA events, "
                  f"median of 5 windows of {n}); K={kp} kernels {sub_ms!r} ms, plain {plain_ms!r} "
                  f"ms, byte-equal; edge counts {c}")
            del maps, counts, got, plain
            torch.cuda.empty_cache()

    def result(self) -> None:
        torch = self.torch
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cudacam_tpu"))
        require(not leaked, f"imported {leaked[:5]}")
        for name in REPLACES:
            require(name in self.ms and name in self.plain_ms and name in self.bound,
                    f"{name}: no time, plain time or bound")
            require(self.launches[name] > 0, f"{name} was never launched on a path")
        kernels = [
            {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": self.launches[name],
                "max_abs_err": self.err[name], "ms": self.ms[name],
                "plain_ms": self.plain_ms[name], "bound_ms": self.bound[name][0],
                "bound_by": self.bound[name][1],
                "library_ms": self.library_ms.get(name),  # None: no one PyTorch call computes it
            }
            for name in REPLACES
        ]
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))


def main() -> int:
    """Every phase, then the result lines."""
    t0 = time.perf_counter()
    try:
        smoke = Smoke()
        phases = [smoke.phase_env, smoke.phase_build, smoke.phase_kernels,
                  smoke.phase_sweep, smoke.phase_engine, smoke.phase_batched_hysteresis,
                  smoke.phase_batched_timing, smoke.phase_sharded,
                  smoke.phase_no_sync, smoke.phase_timing, smoke.phase_sweep_timing,
                  smoke.phase_sharded_timing, smoke.phase_split, smoke.phase_legacy,
                  smoke.phase_probes, smoke.phase_app, smoke.phase_native,
                  smoke.phase_bench, smoke.phase_parity]
        for phase in phases:
            phase()
            print(f"[{phase.__name__} done at {time.perf_counter() - t0:.1f} s]", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    smoke.result()
    return 0


if __name__ == "__main__":
    sys.exit(main())
