"""A NumPy model of the legacy row-sweep kernel's slab chain
(``csrc/hyst_sweep.cu``), held to the port's plain version.

The kernel cannot run here, so this models its data flow word for word: the
pack into the two group layouts (the kernel's ``Geo``), the first window built
from the up layout, the window carried from slab to slab (a shift by
``block_h`` rows, the leaving group stored, the entering group read from the
other layout, prefetched at the window's start), the Jacobi steps with their
count and the first step's growth as the slab's change, the turn between
sweeps with no move, the flush of the last window, and the unpack from the
last sweep's layout. The FINAL down plane starts as garbage, as the kernel's
scratch does: no group of it may be read before a down sweep wrote it. Every
case is held to ``hysteresis_sweeps_plain`` byte for byte with ``info[:2]``
equal (tolerance 0), at widths and block heights of the card tests, at the
pitch of the shared-memory form (the width) and at the padded pitches of the
register instances, converged and cut off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cudacam_tpu_torch.io.sources import make_scene, make_spiral_thresh
from cudacam_tpu_torch.ops.cuda.hysteresis import HALO, hysteresis_sweeps_plain

M32 = np.uint64(0xFFFFFFFF)
#: The register instances of the kernel (``CC_SWEEP_FORMS``): J columns a
#: thread, WR window words a column.
REG_FORMS = ((8, 1), (4, 2), (8, 2), (4, 3), (2, 4), (4, 4), (2, 5))


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """The kernel's geometry of an (h, w) map at ``block_h``, as ``Geo``
    holds it: window rows and words a column, words of a group, the groups
    of the 2 HALO extra rows, slabs, groups a layout holds, the pitch."""

    block_h: int
    rows: int
    wr: int
    group_words: int
    extra: int
    slabs: int
    groups: int
    pitch: int

    @property
    def up_origin(self) -> int:
        return 2 * HALO - self.extra * self.block_h


def chain_layout(h: int, w: int, block_h: int, pitch: int = 0) -> ChainLayout:
    """The geometry with ``pitch`` words a word row (0: the width, as the
    shared-memory form takes it; a register form's pitch is its block's
    columns, past the width)."""
    rows = block_h + 2 * HALO
    slabs, extra = -(-h // block_h), -(-2 * HALO // block_h)
    assert pitch == 0 or pitch >= w
    return ChainLayout(block_h, rows, -(-rows // 32), -(-block_h // 32), extra, slabs,
                       slabs + extra, pitch or w)


def reg_pitch(w: int, cols: int) -> int:
    """The pitch of a register instance of ``cols`` columns a thread: its
    block's columns, whole warps."""
    return -(-(-(-w // cols)) // 32) * 32 * cols


def _get32(a, off: int):
    """Bits [off, off + 32) of the bit string whose 32-bit words are ``a``
    (word k holds bits 32 k ..), zero outside it: the kernel's ``get32``."""
    q, s = off >> 5, off & 31
    lo = a[q] if 0 <= q < len(a) else np.zeros_like(a[0])
    hi = a[q + 1] if 0 <= q + 1 < len(a) else np.zeros_like(a[0])
    if s == 0:
        return lo.copy()
    return ((lo >> np.uint64(s)) | (hi << np.uint64(32 - s))) & M32


def _low(n: int) -> np.uint64:
    """The low ``n`` bits of a word (all 32 when n >= 32)."""
    return M32 if n >= 32 else np.uint64((1 << max(n, 0)) - 1)


def _pack(t: np.ndarray, lay: ChainLayout, origin: int, value: int) -> np.ndarray:
    """(groups, group_words, pitch) words of a layout with ``origin``: bit i
    of word g of group u is padded row origin + u bh + 32 g + i == value."""
    h, w = t.shape
    out = np.zeros((lay.groups, lay.group_words, lay.pitch), np.uint64)
    for u in range(lay.groups):
        for g in range(lay.group_words):
            for i in range(min(32, lay.block_h - 32 * g)):
                r = origin + u * lay.block_h + 32 * g + i - HALO
                if 0 <= r < h:
                    out[u, g, :w] |= (t[r] == value).astype(np.uint64) << np.uint64(i)
    return out


def _step(F, C):
    """One promotion step on the (wr, pitch) window: (new F, grew)."""
    V = [f | ((f << np.uint64(1)) & M32) | (f >> np.uint64(1)) for f in F]
    for k in range(len(F)):  # the carries across word rows
        if k > 0:
            V[k] |= F[k - 1] >> np.uint64(31)
        if k < len(F) - 1:
            V[k] |= (F[k + 1] << np.uint64(31)) & M32
    nF = []
    for f, c, v in zip(F, C, V):
        nb = v.copy()
        nb[1:] |= v[:-1]
        nb[:-1] |= v[1:]
        nF.append(f | (c & nb))
    return nF, any(bool((a != b).any()) for a, b in zip(nF, F))


def chain_model(t: np.ndarray, lay: ChainLayout, max_iters: int, max_local_iters: int,
                remove_candidates: bool):
    """The kernel's three phases on the map ``t``: (out, info)."""
    h, w = t.shape
    bh, wr, gw, E, n, rows = lay.block_h, lay.wr, lay.group_words, lay.extra, lay.slabs, lay.rows
    oU = lay.up_origin
    FU, CU = _pack(t, lay, oU, 255), _pack(t, lay, oU, 128)
    CD = _pack(t, lay, 0, 128)
    FD = np.full_like(FU, 0xFFFFFFFF)  # scratch: never read before written
    max_sweeps = 2 * max_iters if max_iters > 0 else 1

    def window0(P):  # the up layout's groups 0..E placed at their rows
        win = [np.zeros(lay.pitch, np.uint64) for _ in range(wr)]
        for u in range(E + 1):
            start = oU + u * bh
            for k in range(wr):
                win[k] |= _get32(list(P[u]), 32 * k - start)
        return win

    def group_of(win, off):  # the group of window bits [off, off + bh)
        return np.stack([_get32(win, off + 32 * g) & _low(bh - 32 * g) for g in range(gw)])

    F, C = window0(FU), window0(CU)
    sweeps, steps, changed = 0, 0, 0
    while True:
        down = sweeps % 2 == 0
        changed = 0
        for j in range(n):
            b = j if down else n - 1 - j
            pf = None
            if j < n - 1:  # prefetch the group the next move brings in
                pf = (list(FU[b + 1 + E]), list(CU[b + 1 + E])) if down else \
                    (list(FD[b - 1]), list(CD[b - 1]))
            it, first = 0, False
            while it < max_local_iters:
                F, grew = _step(F, C)
                it += 1
                if it == 1:
                    first = grew
                if not grew:
                    break
            steps += it
            changed |= first
            if pf is None:
                continue
            # in place, as the kernel moves it: k ascending down, descending up
            if down:  # leave group b of the down layout, enter rows at window bit 16
                FD[b] = group_of(F, 0)
                for k in range(wr):
                    F[k] = _get32(F, bh + 32 * k) | _get32(pf[0], 32 * k - 2 * HALO)
                    C[k] = _get32(C, bh + 32 * k) | _get32(pf[1], 32 * k - 2 * HALO)
            else:  # leave group b + E of the up layout, enter rows at window bit 0
                FU[b + E] = group_of(F, 2 * HALO)
                for k in reversed(range(wr)):
                    F[k] = (_get32(F, 32 * k - bh) & _low(rows - 32 * k)) | _get32(pf[0], 32 * k)
                    C[k] = (_get32(C, 32 * k - bh) & _low(rows - 32 * k)) | _get32(pf[1], 32 * k)
        sweeps += 1
        if not (changed and sweeps < max_sweeps):
            break
    ended_down = sweeps % 2 == 1
    for u in range(E + 1):  # flush the last window into the last sweep's layout
        if ended_down:
            FD[n - 1 + u] = group_of(F, u * bh)
        else:
            FU[u] = group_of(F, oU + u * bh)
    plane, origin = (FD, 0) if ended_down else (FU, oU)
    out = np.empty_like(t)
    for r in range(h):
        q = r + HALO - origin
        u, i = q // bh, q % bh
        bit = (plane[u, i // 32, :w] >> np.uint64(i % 32)) & np.uint64(1)
        keep = np.zeros_like(t[r]) if remove_candidates else t[r]
        out[r] = np.where(bit == 1, 255, keep)
    return out, [sweeps, int(changed), steps]


def _random_map(h, w, seed, p_final=0.03):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 128, 255], np.uint8), size=(h, w),
                      p=[0.5, 0.5 - p_final, p_final])


def _check(t, block_h, cuts, pitches=None):
    h, w = t.shape
    for pitch in (0, reg_pitch(w, 8)) if pitches is None else pitches:
        lay = chain_layout(h, w, block_h, pitch)
        for max_iters, max_local in cuts:
            for rc in (True, False):
                got, info = chain_model(t, lay, max_iters, max_local, rc)
                want, winfo = hysteresis_sweeps_plain(
                    torch.from_numpy(t), max_iters=max_iters, remove_candidates=rc,
                    block_h=block_h, max_local_iters=max_local, return_info=True)
                kw = dict(pitch=lay.pitch, max_iters=max_iters, max_local=max_local, rc=rc)
                np.testing.assert_array_equal(got, want.numpy(), err_msg=str(kw))
                assert info[:2] == winfo[:2].tolist(), kw


CUTS = ((100, 4096), (1, 4096), (100, 1), (0, 3), (3, 0))


@pytest.mark.parametrize("block_h", [1, 15, 16, 17, 48, 64, 112, 128])
def test_chain_model_is_the_plain_version_at_every_block_h(block_h):
    _check(_random_map(45, 33, block_h), block_h, CUTS)


@pytest.mark.parametrize("w", [1, 31, 32, 33, 63, 65])
@pytest.mark.parametrize("block_h", [16, 17])
def test_chain_model_is_the_plain_version_at_odd_widths(w, block_h):
    _check(_random_map(37, w, w), block_h, CUTS[:3])


@pytest.mark.parametrize("max_iters,max_local", [(100, 4096), (2, 4096), (3, 16)])
def test_chain_model_on_the_spiral_cut_off(max_iters, max_local):
    t = make_spiral_thresh(64, 128)
    _check(t, 16, ((max_iters, max_local),))


def test_chain_model_on_a_scene_converges_to_the_plain_fixed_point():
    from cudacam_tpu_torch.ops import torch_ops
    from cudacam_tpu_torch import CannyConfig, CannyStage

    h, w = 72, 100
    frame = torch.from_numpy(make_scene(h, w, seed=0))
    tmap = torch_ops.canny_to_stage(frame, torch.tensor(10), torch.tensor(40),
                                    CannyConfig(height=h, width=w), CannyStage.THRESH).numpy()
    _check(tmap, 16, ((100, 4096), (2, 4096)))


@pytest.mark.parametrize("cols,wr", REG_FORMS + ((0, 1), (0, 5)))
@pytest.mark.parametrize("past", [-1, 1])
def test_chain_model_at_each_form_pitch(cols, wr, past):
    """Each register instance's geometry (a block height of its window
    words, a width one column short of and one past a whole block of warps,
    the pitch padded to the block) and the shared-memory form's (the pitch
    is the width), converged and cut off."""
    block_h = {1: 16, 2: 48, 3: 64, 4: 112, 5: 128}[wr]
    assert chain_layout(1, 1, block_h).wr == wr
    w = 32 * (cols or 2) + past
    t = _random_map(2 * block_h + 5, w, 31 * cols + wr + past)
    pitch = reg_pitch(w, cols) if cols else 0
    _check(t, block_h, CUTS[:3], pitches=(pitch,))
