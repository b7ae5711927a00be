"""Bit-packed hysteresis in plain PyTorch: the one round schedule.

Port of ``cudacam_tpu/ops/bitpack.py``. The FINAL and CANDIDATE masks are
packed 32 pixels per word VERTICALLY: bit j of word [k, c] is pixel
[32k + j, c], giving (ceil(H/32), W) planes. Promotion runs in rounds:
``dilates`` (``dilate_steps`` bit-parallel 8-neighbour dilations, every
``carry_every``-th and the last one exact across word boundaries) and,
after ``scan_after`` rounds still growing, ``scans`` (8-direction
carry-lookahead doubling scans). The schedule, step cadence and direction
order are the JAX package's, so outputs cut off by the ``max_iters`` cap
match it bit for bit.

Packed planes cross module boundaries as ``torch.int32`` tensors holding
the uint32 bits. The round operators work on int64 words in [0, 2^32):
torch has no uint32 shifts on the CPU, and int32 ``>>`` is arithmetic, so a
right shift would smear bit 31 (image row 31 of each word) downward.

This is the plain version of the two hysteresis kernels
(``csrc/hyst_rounds.cu``). The round loops read the convergence flag back to
the host; the kernels do not.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from cudacam_tpu_torch.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE

_MASK = 0xFFFFFFFF
_CARRY_EVERY = 8


def to_words(plane: torch.Tensor) -> torch.Tensor:
    """int32 packed plane -> int64 words in [0, 2^32)."""
    return plane.to(torch.int64) & _MASK


def from_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 plane with the same bits."""
    return ((words ^ 0x80000000) - 0x80000000).to(torch.int32)


def _bit_index(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device).view(1, 32, 1)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool -> (ceil(H/32), W) int64 words, LSB = top row."""
    h, w = mask.shape
    hw = -(-h // 32)
    m = F.pad(mask.to(torch.int64), (0, 0, 0, hw * 32 - h))
    return (m.view(hw, 32, w) << _bit_index(mask.device)).sum(dim=1)


def pack_pair(thresh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the FINAL and CANDIDATE masks of a (H, W) uint8 threshold map
    into two int32 planes."""
    return (
        from_words(pack_mask(thresh == FINAL_EDGE)),
        from_words(pack_mask(thresh == CANDIDATE_EDGE)),
    )


def unpack_mask(plane: torch.Tensor, height: int) -> torch.Tensor:
    """(Hw, W) int32 plane -> (height, W) bool."""
    hw, w = plane.shape
    bits = (to_words(plane).view(hw, 1, w) >> _bit_index(plane.device)) & 1
    return bits.view(hw * 32, w)[:height].to(torch.bool)


# Shift primitives on int64 word planes, zero fill at every border.


def _shift_words(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i, :] = x[i - k, :] (whole-word, 32-image-row shifts)."""
    if k == 0:
        return x
    hw = x.shape[0]
    if abs(k) >= hw:
        return torch.zeros_like(x)
    if k > 0:
        return F.pad(x[: hw - k], (0, 0, k, 0))
    return F.pad(x[-k:], (0, 0, 0, -k))


def _shift_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, c] = x[:, c - k] (image columns)."""
    if k == 0:
        return x
    w = x.shape[1]
    if abs(k) >= w:
        return torch.zeros_like(x)
    if k > 0:
        return F.pad(x[:, : w - k], (k, 0))
    return F.pad(x[:, -k:], (0, -k))


def _shift_px(x: torch.Tensor, s: int) -> torch.Tensor:
    """Shift the packed bit stream by ``s`` image rows: out[row r] =
    x[row r - s], carrying bits across word boundaries."""
    if s == 0:
        return x
    q, r = divmod(abs(s), 32)
    if s > 0:
        base = _shift_words(x, q)
        if r == 0:
            return base
        return ((base << r) & _MASK) | (_shift_words(base, 1) >> (32 - r))
    base = _shift_words(x, -q)
    if r == 0:
        return base
    return (base >> r) | ((_shift_words(base, -1) << (32 - r)) & _MASK)


def _shift_px_inexact(x: torch.Tensor, s: int) -> torch.Tensor:
    """1-row vertical shift WITHOUT the cross-word carry (the cheap
    intermediate dilation step)."""
    return (x << 1) & _MASK if s > 0 else x >> 1


def _doubling_steps(extent: int) -> Tuple[int, ...]:
    """Powers of two < extent."""
    steps, s = [], 1
    while s < extent:
        steps.append(s)
        s *= 2
    return tuple(steps)


def _scan_dir(f, p, shift, steps: Sequence[int]):
    """Inclusive doubling scan of (generate, propagate) pairs along one
    direction; ``shift(x, s)`` fetches the value ``s`` cells upstream."""
    g, pp = f, p
    for s in steps:
        g = g | (pp & shift(g, s))
        pp = pp & shift(pp, s)
    return g


def _dilate8(f, p, exact: bool, shift_cols, shift_px_1, shift_px_1_inexact):
    """One promotion step f | (p & 8-neighbourhood-OR(f)); the inexact
    vertical OR drops the cross-word carry (safe as an intermediate step:
    monotone and below the fixed point). Every round's last step is exact."""
    v = f | shift_cols(f, 1) | shift_cols(f, -1)
    if exact:
        h = v | shift_px_1(v, 1) | shift_px_1(v, -1)
    else:
        h = v | shift_px_1_inexact(v, 1) | shift_px_1_inexact(v, -1)
    return f | (p & h)


def _make_ops(h: int, w: int, dilate_steps: int, carry_every: int = _CARRY_EVERY,
              shifts=None) -> Tuple[Callable, Callable]:
    """The two promotion operators on int64 words: ``dilates`` and
    ``scans``, in the JAX package's step cadence and direction order.
    ``h``/``w`` are the logical frame dims (they size the doubling steps)."""
    shift_cols, shift_px, shift_px_ix = shifts or (_shift_cols, _shift_px, _shift_px_inexact)
    hsteps = _doubling_steps(w)
    vsteps = _doubling_steps(h)
    dsteps = _doubling_steps(min(h, w))
    directions = (
        (lambda x, s: shift_cols(x, s), hsteps),                 # left -> right
        (lambda x, s: shift_cols(x, -s), hsteps),                # right -> left
        (lambda x, s: shift_px(x, s), vsteps),                   # top -> bottom
        (lambda x, s: shift_px(x, -s), vsteps),                  # bottom -> top
        (lambda x, s: shift_cols(shift_px(x, s), s), dsteps),    # down-right
        (lambda x, s: shift_cols(shift_px(x, -s), -s), dsteps),  # up-left
        (lambda x, s: shift_cols(shift_px(x, s), -s), dsteps),   # down-left
        (lambda x, s: shift_cols(shift_px(x, -s), s), dsteps),   # up-right
    )

    def scans(f, p):
        for shift, steps in directions:
            f = _scan_dir(f, p, shift, steps)
        return f

    def dilates(f, p):
        for i in range(1, dilate_steps + 1):
            exact = (i % carry_every == 0) or (i == dilate_steps)
            f = _dilate8(f, p, exact, shift_cols, shift_px, shift_px_ix)
        return f

    return dilates, scans


def converge_phase1(
    f: torch.Tensor,
    p: torch.Tensor,
    h: int,
    w: int,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    carry_every: int = _CARRY_EVERY,
) -> Tuple[torch.Tensor, int, bool]:
    """Phase 1: one unconditional round of dilations, then rounds while the
    state grows, up to ``min(scan_after, max_iters)``. Returns (plane,
    round count, still growing)."""
    dilates, _ = _make_ops(h, w, dilate_steps, carry_every)
    fw, pw = to_words(f), to_words(p)
    cap = min(scan_after, max_iters)
    it = 0
    while True:
        nf = dilates(fw, pw)
        changed = bool((nf != fw).any())
        fw, it = nf, it + 1
        if not (changed and it < cap):
            return from_words(fw), it, changed


def converge_phase2(
    f: torch.Tensor,
    p: torch.Tensor,
    h: int,
    w: int,
    it0: int,
    dilate_steps: int = 16,
    max_iters: int = 100,
    carry_every: int = _CARRY_EVERY,
) -> Tuple[torch.Tensor, int, bool]:
    """Phase 2, resumed at round ``it0`` on a state still growing: rounds of
    dilations then the 8-direction scans while the state changes and the
    round count is below ``max_iters``."""
    dilates, scans = _make_ops(h, w, dilate_steps, carry_every)
    fw, pw = to_words(f), to_words(p)
    it, changed = it0, True
    while changed and it < max_iters:
        nf = scans(dilates(fw, pw), pw)
        changed = bool((nf != fw).any())
        fw, it = nf, it + 1
    return from_words(fw), it, changed


def converge_packed(
    f: torch.Tensor,
    p: torch.Tensor,
    h: int,
    w: int,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    carry_every: int = _CARRY_EVERY,
) -> Tuple[torch.Tensor, int, bool]:
    """Both phases on packed planes: (plane, iters, growing), where growing
    means the cap stopped a state that was still changing."""
    f1, it, growing = converge_phase1(
        f, p, h, w, dilate_steps, scan_after, max_iters, carry_every
    )
    if not growing:
        return f1, it, growing
    return converge_phase2(f1, p, h, w, it, dilate_steps, max_iters, carry_every)


def hysteresis_packed(
    thresh: torch.Tensor,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
) -> torch.Tensor:
    """Hysteresis of a (H, W) uint8 threshold map: pack, converge, unpack
    (remaining candidates become NO_EDGE)."""
    h, w = thresh.shape
    f, p = pack_pair(thresh)
    f_fix, _, _ = converge_packed(
        f, p, h, w, dilate_steps=dilate_steps, scan_after=scan_after,
        max_iters=max_iters,
    )
    reached = unpack_mask(f_fix, h)
    return torch.where(
        reached,
        torch.full_like(thresh, FINAL_EDGE),
        torch.full_like(thresh, NO_EDGE),
    )
