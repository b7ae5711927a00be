"""The hysteresis-construct probes (K13) on Hopper.

Port of ``tools/hyster_kernel_probe.py``, whose four TPU kernels
(``pallas_call`` at :42, :68, :114, :150) try each risky Mosaic construct of
the fused hysteresis kernel alone. Here each contract is a hand-written
kernel (``csrc/probe_hyster.cu``) that tries the construct risky on Hopper,
beside its plain PyTorch version:

* :func:`probe_pack` (TPU probe A): an (h, w) u8 mask -> (ceil(h/32), w)
  words, bit r of word row k = row 32k + r; a 32-row tile staged in shared
  memory (16 bytes a lane where a row's address allows, else aligned 4-byte
  words cut by a funnel shift) and transposed into words, a thread's 4
  columns by SWAR (:func:`probe_pack_layout`);
* :func:`probe_pack_ballot` (A'): the same pack with no shared memory,
  ``__ballot_sync`` over 32 lanes holding 32 rows; warp tasks of one word
  row x 32 columns over the whole card, full-sector loads where a row's
  address allows (:func:`probe_pack_ballot_grid`);
* :func:`probe_loop` (B/C/D): ``f | roll(f, 1, rows) | roll(f, w-1, cols) |
  f << 1`` until nothing changes or the round budget, in one launch that
  ends on a device flag: the plane held in one block's registers with one
  ``__syncthreads_or`` a round where it fits, else one cooperative launch
  with a ``grid.sync()`` a round
  (:func:`probe_loop_layout`); its sync-only mode times the grid barrier
  alone;
* :func:`probe_unpack` (E): words -> (32 hw, w) u8 of 0 / 255, a thread per
  word or, in the byte mode, a thread's work inside one output row: a
  16-byte run of a row from 16 words, the 32 rows of a word row in one
  block (:func:`probe_unpack_layout`).

Words cross the module as int32 tensors holding the uint32 bits. Each
wrapper takes its plain version for CPU tensors and launches its kernel (or
raises) for CUDA tensors. :func:`run_probes` runs the four on the TPU
probe's inputs.
"""
from __future__ import annotations

import ctypes
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
    32-row tile in shared memory and transposes it into words
    (:func:`probe_pack_layout`)."""
    return _pack(mask, False)


#: ``probe_pack_layout``'s keys, in ``cc_probe_pack_layout``'s order.
PROBE_PACK_LAYOUT_KEYS = ("route", "threads", "blocks", "tile_columns", "columns_per_thread",
                          "smem_bytes")
#: :func:`probe_pack`'s tile columns (``PACK_TW`` in ``csrc/probe_hyster.cu``).
PACK_TILE_COLUMNS = 512


def probe_pack_layout(h: int, w: int, offset: int = 0) -> dict:
    """The launch :func:`probe_pack` makes for an (h, w) mask whose first
    byte lies ``offset`` bytes past a 16-byte boundary: ``route`` "vector"
    (every row's address 16-byte aligned: ``w % 16 == 0`` and an aligned
    mask; a lane stages 16 bytes of a row a step) or "general" (16 bytes
    a lane for a row whose address is 16-byte aligned, else aligned 4-byte
    words cut by a funnel shift), threads a block (a thread's 4 columns),
    blocks (grid
    (ceil(w / 512), min(ceil(h / 32), 65535))), the tile's columns, columns
    a thread and a block's shared memory (the 32-row tile). The rule of
    ``csrc/probe_hyster.cu``; :func:`probe_pack_layout_cc` reads the
    kernel library's own."""
    tw = PACK_TILE_COLUMNS
    return dict(route="vector" if w % 16 == 0 and offset % 16 == 0 else "general",
                threads=tw // 4, blocks=-(-w // tw) * min(-(-h // 32), 65535), tile_columns=tw,
                columns_per_thread=4, smem_bytes=32 * tw)


def probe_pack_layout_cc(h: int, w: int, offset: int = 0) -> dict:
    """:func:`probe_pack_layout` as the kernel library computes it
    (``cc_probe_pack_layout``; needs the built library)."""
    out = (ctypes.c_int * len(PROBE_PACK_LAYOUT_KEYS))()
    lib = load()
    lib.check(lib.lib.cc_probe_pack_layout(h, w, offset, ctypes.cast(out, ctypes.c_void_p)),
              "cc_probe_pack_layout")
    lay = dict(zip(PROBE_PACK_LAYOUT_KEYS, out))
    lay["route"] = "vector" if lay["route"] else "general"
    return lay


def probe_pack_ballot(mask: torch.Tensor) -> torch.Tensor:
    """:func:`probe_pack` with no shared memory: a warp's task is one word
    row x 32 columns, lane r holding row 32k + r, and each of the 32 words
    is one ``__ballot_sync``; the tasks are spread over the whole card."""
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


def probe_pack_ballot_grid(h: int, w: int, device: int = 0) -> dict:
    """The grid :func:`probe_pack_ballot` launches for an (h, w) mask on a
    card: blocks, threads a block, tasks (word rows x 32-column groups) and
    the tasks a warp has in flight (``cc_probe_ballot_grid``)."""
    out = (ctypes.c_int * 4)()
    lib = load()
    lib.check(lib.lib.cc_probe_ballot_grid(h, w, device, ctypes.cast(out, ctypes.c_void_p)),
              "cc_probe_ballot_grid")
    return dict(zip(("blocks", "threads", "tasks", "tasks_in_flight"), out))


#: ``probe_loop_layout``'s keys, in ``cc_probe_loop_layout``'s order.
PROBE_LOOP_LAYOUT_KEYS = ("route", "blocks", "threads", "words_per_thread", "smem_bytes",
                          "barriers_per_round")


def probe_loop_layout(hw: int, w: int, device: int = 0) -> dict:
    """The route :func:`probe_loop` takes for an (hw, w) plane on a card
    with its default grid: ``route`` ("resident": the plane in one block's
    registers; "grid": the cooperative launch), the blocks, threads a
    block, words a thread at most, a block's shared memory in bytes, and
    the barriers a round (``cc_probe_loop_layout``; the rule is
    ``probe_loop_plan``'s in C)."""
    out = (ctypes.c_int * len(PROBE_LOOP_LAYOUT_KEYS))()
    lib = load()
    lib.check(lib.lib.cc_probe_loop_layout(hw, w, device, ctypes.cast(out, ctypes.c_void_p)),
              "cc_probe_loop_layout")
    lay = dict(zip(PROBE_LOOP_LAYOUT_KEYS, out))
    lay["route"] = "resident" if lay["route"] else "grid"
    return lay


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

    On CUDA tensors: one launch that ends on a device flag, no readback.
    By default the route follows the plane's size (:func:`probe_loop_layout`):
    the plane resident in one block's registers where it fits, else the
    cooperative grid route over the plane's words up to the cooperative
    limit. ``blocks``: the grid route on exactly that grid. ``sync_only``:
    the grid route's barriers alone (``max_rounds`` of them), the plane
    unchanged and (max_rounds, 0) out."""
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


#: ``probe_unpack_layout``'s keys, in ``cc_probe_unpack_layout``'s order.
PROBE_UNPACK_LAYOUT_KEYS = ("route", "threads", "blocks", "bytes_per_thread")


def probe_unpack_layout(hw: int, w: int, per_word: bool = True) -> dict:
    """The launch :func:`probe_unpack` makes for (hw, w) words: ``route``
    "word" (a thread per word, a grid-stride loop over at most 2^20 blocks)
    or "runs" (the byte mode: a thread per 16-byte run of one output row, a
    block the 32 rows of a word row at 8 runs each, grid (ceil(ceil(w / 16)
    / 8), min(hw, 65535))), threads a block, blocks, output bytes a thread.
    The rule of ``csrc/probe_hyster.cu``; :func:`probe_unpack_layout_cc`
    reads the kernel's own."""
    if per_word:
        return dict(route="word", threads=256, blocks=min(max(-(-hw * w // 256), 1), 1 << 20),
                    bytes_per_thread=32)
    runs = -(-w // 16)  # a row's runs at most
    return dict(route="runs", threads=256, blocks=-(-runs // 8) * min(hw, 65535),
                bytes_per_thread=16)


def probe_unpack_layout_cc(hw: int, w: int, per_word: bool = True) -> dict:
    """:func:`probe_unpack_layout` as the kernel library computes it
    (``cc_probe_unpack_layout``; needs the built library)."""
    out = (ctypes.c_int * len(PROBE_UNPACK_LAYOUT_KEYS))()
    lib = load()
    lib.check(lib.lib.cc_probe_unpack_layout(hw, w, int(per_word),
                                             ctypes.cast(out, ctypes.c_void_p)),
              "cc_probe_unpack_layout")
    lay = dict(zip(PROBE_UNPACK_LAYOUT_KEYS, out))
    lay["route"] = "runs" if lay["route"] else "word"
    return lay


def probe_unpack(f: torch.Tensor, per_word: bool = True) -> torch.Tensor:
    """(hw, w) int32 words -> (32 hw, w) uint8: 255 where bit r of word row
    k is set at row 32k + r, else 0. ``per_word``: one thread per word
    writing its 32 bytes; else the byte mode, a thread per 16-byte run of
    one output row (:func:`probe_unpack_layout`)."""
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
