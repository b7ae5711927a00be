"""The thread layout of the ``unpack`` kernel (``csrc/hyst_rounds.cu``) as a
NumPy model, against ``unpack_plain``.

A block of ``UNPACK_NT`` threads takes part p of the 32 image rows of word
row k of one plane (NRH parts), ``UNPACK_SEG`` columns of them from c0 =
seg * UNPACK_SEG (block x = (k NRH + p) nseg + seg, block y = the plane): it
stages those words and the 16 after them in shared memory, a padding word
every 32 (word q at q + q // 32), with coalesced loads. Lane l of warp v
owns the 32 columns from c0 + 32 l and the ``UNPACK_ROWS`` image rows
32 k + (p NT / 32 + v) UNPACK_ROWS + jj below h: per row it
gathers that row's bit of its 48 staged words (its own 32, the next 16),
and writes the 16-byte aligned runs of the row that start in its columns,
at columns 32 l + d and 32 l + d + 16, where d is the row's first 16-byte
aligned column, as one vector store each; the thread of column 0 writes the
row's head (the d bytes before its first aligned run) byte by byte, and a
run that passes the row's end (the tail) is written byte by byte up to it.
With an index, plane b lands at out[index[b]]; an index outside [0, B)
writes nothing.

The model holds the layout to ``unpack_plain`` for every width 1..70, 1919
and 1920 at heights 1, 31, 32, 33 and 1080, with and without an index, and
checks every byte of the maps is written exactly once, every vector store is
16-byte aligned and inside its row, and the staged reads are free of bank
conflicts.

Tolerance: 0. Every value is an output byte.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudacam_tpu_torch.ops.cuda.megakernel import unpack, unpack_plain

torch.set_num_threads(2)

_SRC = Path(__file__).resolve().parents[1] / "cudacam_tpu_torch" / "csrc" / "hyst_rounds.cu"


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text()).group(1))


#: The kernel's layout, read from its source so the model follows it.
SEG, ROWS, NT = _const("UNPACK_SEG"), _const("UNPACK_ROWS"), _const("UNPACK_NT")
NRH = 32 // (NT // 32 * ROWS)
STAGED = SEG + 16


def model_unpack(f: np.ndarray, h: int, index=None, base: int = 0) -> np.ndarray:
    """(B, ceil(h/32), w) int32 planes -> (B, h, w) uint8 maps, thread by
    thread; ``base`` is the maps' address modulo 16."""
    nb, hw, w = f.shape
    words = f.view(np.uint32).astype(np.int64)
    out = np.full((nb, h, w), 7, np.uint8)
    written = np.zeros((nb, h, w), np.int64)
    nseg = -(-w // SEG)
    bx, tid = np.meshgrid(np.arange(hw * NRH * nseg), np.arange(NT), indexing="ij")
    bx, tid = bx.ravel(), tid.ravel()
    kr, c0 = bx // nseg, (bx % nseg) * SEG
    k, rpart = kr // NRH, kr % NRH
    lane, warp = tid & 31, tid >> 5
    cg = c0 + 32 * lane
    live = cg < w
    k, rpart, c0, lane, warp, cg = (k[live], rpart[live], c0[live], lane[live], warp[live],
                                    cg[live])
    q = 32 * lane[:, None] + np.arange(48)[None, :]  # staged word a lane reads
    assert q.max(initial=0) < STAGED
    for by in range(nb):
        to = by if index is None else int(index[by])
        if not 0 <= to < nb:
            continue
        col = c0[:, None] + q
        wd = np.where(col < w, words[by, k[:, None], np.minimum(col, w - 1)], 0)
        for jj in range(ROWS):
            j = (rpart * (NT // 32) + warp) * ROWS + jj
            r = 32 * k + j
            ok = r < h
            if not ok.any():
                continue
            rw, cgw, jw, wdw = r[ok], cg[ok], j[ok], wd[ok]
            bits = (wdw >> jw[:, None]) & 1
            lo = (bits[:, :32] << np.arange(32)).sum(1)
            hi = (bits[:, 32:] << np.arange(16)).sum(1)
            m = lo | (hi << 32)
            addr = base + (to * h + rw) * w  # the row's first byte
            d = (16 - addr % 16) % 16
            # The head, from the thread of column 0.
            for i in np.nonzero(cgw == 0)[0]:
                for c in range(min(d[i], w)):
                    out[to, rw[i], c] = 255 * ((lo[i] >> c) & 1)
                    written[to, rw[i], c] += 1
            for o_off in (0, 16):
                o = d + o_off
                c = cgw + o
                live_c = c < w
                run = (m >> o) & 0xFFFF
                full = live_c & (c + 16 <= w)
                assert ((addr + c)[full] % 16 == 0).all()  # aligned vector stores
                idx = c[full][:, None] + np.arange(16)[None, :]
                rows = np.broadcast_to(rw[full][:, None], idx.shape)
                out[to, rows, idx] = 255 * ((run[full][:, None] >> np.arange(16)) & 1)
                np.add.at(written, (to, rows, idx), 1)
                for i in np.nonzero(live_c & ~full)[0]:  # the tail
                    n = w - c[i]
                    out[to, rw[i], c[i]:w] = 255 * ((run[i] >> np.arange(n)) & 1)
                    written[to, rw[i], c[i]:w] += 1
    mask = np.zeros(nb, bool)
    for by in range(nb):
        to = by if index is None else int(index[by])
        if 0 <= to < nb:
            mask[to] = True
    assert (written[mask] == 1).all(), "a byte was not written exactly once"
    return out


WIDTHS = list(range(1, 71)) + [1919, 1920]
HEIGHTS = [1, 31, 32, 33, 1080]


@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("w", WIDTHS)
def test_layout_matches_plain(h, w):
    rng = np.random.default_rng(h * 10007 + w)
    nb = 3 if h * w < 100_000 else 2
    f = rng.integers(-2**31, 2**31, (nb, -(-h // 32), w), dtype=np.int64).astype(np.int32)
    tf = torch.from_numpy(f)
    index = rng.permutation(nb).astype(np.int32)
    np.testing.assert_array_equal(model_unpack(f, h), unpack_plain(tf, h).numpy())
    np.testing.assert_array_equal(model_unpack(f, h, index),
                                  unpack_plain(tf, h, torch.from_numpy(index)).numpy())
    if w <= 70 and h <= 33:  # the head at every start: maps at an unaligned address
        for base in (1, 9, 15):
            np.testing.assert_array_equal(model_unpack(f, h, base=base), unpack_plain(tf, h).numpy())


def test_out_of_range_index_writes_nothing():
    f = np.arange(2 * 2 * 40, dtype=np.int32).reshape(2, 2, 40)
    got = model_unpack(f, 40, index=np.array([1, 5], np.int32))
    np.testing.assert_array_equal(got[1], unpack_plain(torch.from_numpy(f[0]), 40).numpy())
    assert (got[0] == 7).all()


def test_staged_reads_are_free_of_bank_conflicts():
    lanes = np.arange(32)
    for i in range(48):
        q = 32 * lanes + i
        assert len(set(((q + q // 32) % 32).tolist())) == 32
    for t in range(0, STAGED, NT):  # the staging stores: a warp's 32 consecutive words
        q = t + lanes
        assert len(set(((q + q // 32) % 32).tolist())) == 32


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    f = torch.from_numpy(np.random.default_rng(0).integers(
        -2**31, 2**31, (2, 2, 19), dtype=np.int64).astype(np.int32))
    index = torch.tensor([1, 0], dtype=torch.int32)
    assert torch.equal(unpack(f, 40, index), unpack_plain(f, 40, index))
    assert torch.equal(unpack(f[0], 33), unpack_plain(f[0], 33))
