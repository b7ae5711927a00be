"""The hysteresis-construct probes (K13) on Hopper.

Port of ``tools/hyster_kernel_probe.py``, whose four TPU kernels
(``pallas_call`` at :42, :68, :114, :150) try each risky Mosaic construct of
the fused hysteresis kernel alone. Here each contract is a hand-written
kernel (``csrc/probe_hyster.cu``) that tries the construct risky on Hopper,
beside its plain PyTorch version:

* :func:`probe_pack` (TPU probe A): an (h, w) u8 mask -> (ceil(h/32), w)
  words, bit r of word row k = row 32k + r; a shared-memory tile transposed
  into words;
* :func:`probe_pack_ballot` (A'): the same pack by a loop over word rows,
  ``__ballot_sync`` over 32 lanes holding 32 rows;
* :func:`probe_loop` (B/C/D): ``f | roll(f, 1, rows) | roll(f, w-1, cols) |
  f << 1`` until nothing changes or the round budget, as one cooperative
  launch with a ``grid.sync()`` a round and a device "changed" flag; its
  sync-only mode times the barrier alone;
* :func:`probe_unpack` (E): words -> (32 hw, w) u8 of 0 / 255, a thread per
  word or a thread per byte.

Words cross the module as int32 tensors holding the uint32 bits. Each
wrapper takes its plain version for CPU tensors and launches its kernel (or
raises) for CUDA tensors. :func:`run_probes` runs the four on the TPU
probe's inputs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)

#: The TPU probe's shapes: the mask, the loop plane, the unpacked plane.
PACK_SHAPE = (128, 256)
LOOP_SHAPE = (40, 256)
UNPACK_WORDS = (4, 256)
#: The loop's round budget (the probe's ``it < 400``).
LOOP_ROUNDS = 400


def pack_input(seed: int, h: int = PACK_SHAPE[0], w: int = PACK_SHAPE[1]) -> np.ndarray:
    """The TPU probe's mask: u8, 1 with probability 0.4 (seed 0 for A, 1 for A')."""
    return (np.random.default_rng(seed).random((h, w)) < 0.4).astype(np.uint8)


def loop_input(hw: int = LOOP_SHAPE[0], w: int = LOOP_SHAPE[1]) -> np.ndarray:
    """The TPU probe's loop plane: one set bit, at [3, 5], as int32 words."""
    f = np.zeros((hw, w), np.int32)
    f[3 % hw, 5 % w] = 1
    return f


def unpack_input(seed: int = 2, hw: int = UNPACK_WORDS[0], w: int = UNPACK_WORDS[1]) -> np.ndarray:
    """The TPU probe's random words (uint32, seed 2), as int32."""
    return np.random.default_rng(seed).integers(0, 2**32, (hw, w), dtype=np.uint32).view(np.int32)


def _check_mask(mask: torch.Tensor) -> None:
    if mask.dtype != torch.uint8 or mask.ndim != 2 or mask.numel() == 0:
        raise ValueError(f"expected an (h, w) uint8 mask, got {tuple(mask.shape)} {mask.dtype}")


def _check_words(f: torch.Tensor) -> None:
    if f.dtype != torch.int32 or f.ndim != 2 or f.numel() == 0:
        raise ValueError(f"expected (hw, w) int32 words, got {tuple(f.shape)} {f.dtype}")


def probe_pack_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_pack` and
    :func:`probe_pack_ballot`, on any device: ``bitpack.pack_mask``."""
    return bitpack.from_words(bitpack.pack_mask(mask != 0))


probe_pack_ballot_plain = probe_pack_plain


def _pack(mask: torch.Tensor, ballot: bool) -> torch.Tensor:
    _check_mask(mask)
    if use_plain(mask):
        return probe_pack_plain(mask)
    require_contiguous(mask)
    h, w = mask.shape
    out = torch.empty((-(-h // 32), w), dtype=torch.int32, device=mask.device)
    lib = load()
    name = "probe_pack_ballot" if ballot else "probe_pack"
    lib.check(lib.lib.cc_probe_pack(mask.data_ptr(), out.data_ptr(), h, w, int(ballot),
                                    mask.device.index, stream_of(mask)), name)
    count_launch(name)
    return out


def probe_pack(mask: torch.Tensor) -> torch.Tensor:
    """(h, w) uint8 mask -> (ceil(h/32), w) int32 words: bit r of word row
    k is ``mask[32k + r] != 0`` (rows past h are 0). The kernel stages a
    32-row tile in shared memory and transposes it into words."""
    return _pack(mask, False)


def probe_pack_ballot(mask: torch.Tensor) -> torch.Tensor:
    """:func:`probe_pack` by a loop over word rows, each word one
    ``__ballot_sync`` of 32 lanes holding its 32 rows."""
    return _pack(mask, True)


def probe_loop_plain(
    plane: torch.Tensor, max_rounds: int = LOOP_ROUNDS, *, sync_only: bool = False,
    blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`probe_loop`, on any device
    (``blocks`` is the kernel's grid and changes nothing here)."""
    _check_words(plane)
    if sync_only:
        return plane.clone(), torch.tensor([[max_rounds, 0]], dtype=torch.int32,
                                           device=plane.device)
    f = bitpack.to_words(plane)
    it, changed = 0, True
    while True:  # the first round unconditional
        nf = f | torch.roll(f, 1, 0) | torch.roll(f, -1, 1) | ((f << 1) & 0xFFFFFFFF)
        changed = bool((nf != f).any())
        f, it = nf, it + 1
        if not changed or it >= max_rounds:
            break
    return bitpack.from_words(f), torch.tensor([[it, int(changed)]], dtype=torch.int32,
                                               device=plane.device)


def probe_loop_max_blocks(device: torch.device) -> int:
    """The cooperative grid's limit for :func:`probe_loop` on ``device``."""
    n = load().lib.cc_probe_loop_max_blocks(torch.device(device).index or 0)
    if n < 1:
        raise RuntimeError(f"probe_loop: no cooperative grid on {device} ({n})")
    return n


def probe_loop(
    plane: torch.Tensor, max_rounds: int = LOOP_ROUNDS, *, sync_only: bool = False,
    blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rounds of ``f | roll(f, 1, rows) | roll(f, w-1, cols) | f << 1`` on
    an (hw, w) int32 plane of words (cyclic rolls; the shift drops bit 31 of
    each word), the first round unconditional, then while the last round
    changed a word and fewer than ``max_rounds`` ran. Returns the plane and
    a (1, 2) int32 tensor (rounds, changed), both on the plane's device.

    On CUDA tensors: one cooperative launch of ``blocks`` blocks (default:
    the plane's words, up to the cooperative limit) that ends on a device
    flag, no readback. ``sync_only``: the rounds' grid barriers alone
    (``max_rounds`` of them), the plane unchanged and (max_rounds, 0) out."""
    _check_words(plane)
    if use_plain(plane):
        return probe_loop_plain(plane, max_rounds, sync_only=sync_only)
    if blocks is not None and blocks < 1:
        raise ValueError("blocks must be >= 1")
    hw, w = plane.shape
    out = plane.contiguous().clone()
    scratch = torch.empty(hw * w + 3, dtype=torch.int32, device=plane.device)
    flags = torch.empty((1, 2), dtype=torch.int32, device=plane.device)
    lib = load()
    lib.check(lib.lib.cc_probe_loop(out.data_ptr(), scratch.data_ptr(), flags.data_ptr(), hw, w,
                                    max_rounds, int(sync_only), blocks or 0, plane.device.index,
                                    stream_of(plane)), "probe_loop")
    count_launch("probe_loop")
    return out, flags


def probe_unpack_plain(f: torch.Tensor, per_word: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_unpack`, on any device."""
    _check_words(f)
    reached = bitpack.unpack_mask(f, 32 * f.shape[0])
    return torch.where(reached, 255, 0).to(torch.uint8)


def probe_unpack(f: torch.Tensor, per_word: bool = True) -> torch.Tensor:
    """(hw, w) int32 words -> (32 hw, w) uint8: 255 where bit r of word row
    k is set at row 32k + r, else 0. ``per_word``: one thread per word
    writing its 32 bytes; else one thread per byte."""
    _check_words(f)
    if use_plain(f):
        return probe_unpack_plain(f, per_word)
    require_contiguous(f)
    hw, w = f.shape
    out = torch.empty((32 * hw, w), dtype=torch.uint8, device=f.device)
    lib = load()
    lib.check(lib.lib.cc_probe_unpack(f.data_ptr(), out.data_ptr(), hw, w, int(per_word),
                                      f.device.index, stream_of(f)), "probe_unpack")
    count_launch("probe_unpack")
    return out


def run_probes(device) -> List[Tuple[str, bool, str]]:
    """The four probes on the TPU probe's inputs, on ``device`` (the kernels
    on a card, the plain versions on the CPU): ``(name, ok, detail)`` each.
    A, A' and E are held to ``bitpack``'s pack and unpack; B/C/D passes when
    the loop ended converged, as the TPU probe's test says (its plane and
    rounds are held to the plain version elsewhere)."""
    dev = torch.device(device)
    rows = []
    for name, fn, seed in (("A pack-tile-transpose", probe_pack, 0),
                           ("A' pack-ballot-word-row-loop", probe_pack_ballot, 1)):
        mask = torch.from_numpy(pack_input(seed)).to(dev)
        got = fn(mask).cpu()
        rows.append((name, torch.equal(got, probe_pack_plain(mask.cpu())), ""))
    out, flags = probe_loop(torch.from_numpy(loop_input()).to(dev))
    rounds, changed = flags[0].tolist()
    bits = int(bitpack.unpack_mask(out.cpu(), 32 * out.shape[0]).sum())
    ok = bits > 1 and changed == 0 and 0 < rounds < LOOP_ROUNDS
    rows.append(("B/C/D loop+scratch+flag+rolls", ok,
                 f"(rounds, changed) = ({rounds}, {changed}), {bits} bits set"))
    f = torch.from_numpy(unpack_input()).to(dev)
    for per_word in (True, False):
        got = probe_unpack(f, per_word).cpu()
        want = torch.where(bitpack.unpack_mask(f.cpu(), 32 * f.shape[0]), 255, 0).to(torch.uint8)
        rows.append((f"E unpack-{'word' if per_word else 'byte'}-per-thread",
                     torch.equal(got, want), ""))
    return rows


#: Grid sizes of the barrier table: one block, a few, a quarter, half and all
#: of the H100's 132 SMs (then the cooperative maximum).
SYNC_GRIDS = (1, 8, 33, 66, 132)


def grid_sync_us(device, rounds: int = 1000, grids=SYNC_GRIDS, reps: int = 5):
    """Microseconds per ``grid.sync()`` against the grid size, on a card:
    :func:`probe_loop`'s sync-only mode, ``rounds`` barriers in one launch,
    timed with CUDA events (median of ``reps`` launches, after one warm-up),
    less nothing: the launch's own cost is spread over the rounds. Returns
    ``[(blocks, us), ...]`` for ``grids`` (those that fit) and the
    cooperative maximum."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("grid_sync_us times the card's barrier: pass a CUDA device")
    limit = probe_loop_max_blocks(dev)
    plane = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    table = []
    for blocks in sorted({b for b in grids if b <= limit} | {limit}):
        probe_loop(plane, rounds, sync_only=True, blocks=blocks)
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            probe_loop(plane, rounds, sync_only=True, blocks=blocks)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / rounds)
        table.append((blocks, sorted(times)[len(times) // 2]))
    return table
