"""The thread layout of the unpack kernels (``csrc/unpack.cu``) as a NumPy
model, against ``unpack_plain``, ``unpack_core_plain`` and the JAX package's
``unpack_core_call`` in interpret mode.

Both kernels run one routine, ``unpack_runs``, on one word row of a plane
at a time, and :func:`model_runs` models it for every block of a launch. A
block of ``UNPACK_NT`` threads takes part p of the 32 image rows of one word
row (NRH parts), ``UNPACK_SEG`` columns of them from c0 = seg * UNPACK_SEG:
it stages those words and the 16 after them in shared memory, a padding word
every 32 (word q at q + q // 32), with coalesced loads. Lane l of warp v
owns the 32 columns from c0 + 32 l and bits (p NT / 32 + v) UNPACK_ROWS + jj
of the words: per bit whose row is written it gathers that bit of its 48
staged words (its own 32, the next 16), and writes the 16-byte aligned runs
of the row that start in its columns, at columns 32 l + d and 32 l + d + 16,
where d is the row's first 16-byte aligned column (from the row's address),
as one vector store each; the thread of column 0 writes the row's head (the
d bytes before its first aligned run) byte by byte, and a run that passes the
row's end (the tail) is written byte by byte up to it.

``unpack``: block x = (k NRH + p) nseg + seg, block y = the plane; bit j of
word row k is row 32 k + j of the map (none at or past h); with an index,
plane b lands at out[index[b]], and an index outside [0, B) writes nothing.
``unpack_core``: block y = tile t = (b, i, j); block x walks the word rows
from e_top // 32 to (e_top + h_loc - 1) // 32, the columns from lane e_left;
bit j of word row k is core row 32 k + j - e_top (none outside [0, h_loc)),
at column j w_loc of a row of pitch ow.

The model holds ``unpack``'s layout to ``unpack_plain`` for every width
1..70, 1919 and 1920 at heights 1, 31, 32, 33 and 1080, with and without an
index, and ``unpack_core``'s to ``unpack_core_plain`` at bit offsets e_top %
32 of 0, 1 and 31, lane offsets, cores of widths and pitches that are not
multiples of 16 (heads and tails at every column split) and of two segments,
and to ``unpack_core_call``; it checks every byte of the maps is written
exactly once, every vector store is 16-byte aligned and inside its row, and
the staged reads are free of bank conflicts.

Tolerance: 0. Every value is an output byte.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.ops.pallas.megakernel import unpack_core_call
from cudacam_tpu_torch.ops.cuda.feedforward import Tiling
from cudacam_tpu_torch.ops.cuda.megakernel import (
    unpack, unpack_core, unpack_core_plain, unpack_plain,
)

torch.set_num_threads(2)

_SRC = Path(__file__).resolve().parents[1] / "cudacam_tpu_torch" / "csrc" / "unpack.cu"


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text()).group(1))


#: The kernels' layout, read from their source so the model follows it.
SEG, ROWS, NT = _const("UNPACK_SEG"), _const("UNPACK_ROWS"), _const("UNPACK_NT")
NRH = 32 // (NT // 32 * ROWS)
STAGED = SEG + 16


def model_runs(words, n, wrow, rpart, c0, row_at, size, base=0):
    """``unpack_runs`` for every block of a launch, thread by thread.

    ``words``: (R, n) int64 word rows, each from the routine's column 0;
    block b stages row ``wrow[b]``, takes part ``rpart[b]`` of its 32 bits
    and columns from ``c0[b]``; ``row_at(blocks, j)`` gives the flat offset
    of the n-byte output row that bit j of those blocks goes to, or -1.
    Returns the flat output (7 where nothing was written) and the writes of
    each byte; ``base`` is the output's address modulo 16."""
    out = np.full(size, 7, np.uint8)
    written = np.zeros(size, np.int64)
    bid, tid = np.meshgrid(np.arange(len(wrow)), np.arange(NT), indexing="ij")
    bid, tid = bid.ravel(), tid.ravel()
    lane, warp = tid & 31, tid >> 5
    cg = c0[bid] + 32 * lane  # the thread's first column
    live = cg < n
    bid, lane, warp, cg = bid[live], lane[live], warp[live], cg[live]
    q = 32 * lane[:, None] + np.arange(48)[None, :]  # the staged words a lane reads
    assert q.max(initial=0) < STAGED
    col = c0[bid][:, None] + q
    wd = np.where(col < n, words[wrow[bid][:, None], np.minimum(col, n - 1)], 0)
    for jj in range(ROWS):
        j = (rpart[bid] * (NT // 32) + warp) * ROWS + jj
        row = row_at(bid, j)
        ok = row >= 0
        rw, cgw, jw, wdw = row[ok], cg[ok], j[ok], wd[ok]
        bits = (wdw >> jw[:, None]) & 1
        lo = (bits[:, :32] << np.arange(32)).sum(1)
        hi = (bits[:, 32:] << np.arange(16)).sum(1)
        m = lo | (hi << 32)
        d = (16 - (base + rw) % 16) % 16
        for i in np.nonzero(cgw == 0)[0]:  # the head, from the thread of column 0
            for c in range(min(d[i], n)):
                out[rw[i] + c] = 255 * ((lo[i] >> c) & 1)
                written[rw[i] + c] += 1
        for o_off in (0, 16):
            c = cgw + d + o_off
            live_c = c < n
            run = (m >> (d + o_off)) & 0xFFFF
            full = live_c & (c + 16 <= n)
            assert ((base + rw + c)[full] % 16 == 0).all()  # aligned vector stores
            idx = (rw + c)[full][:, None] + np.arange(16)[None, :]
            out[idx] = 255 * ((run[full][:, None] >> np.arange(16)) & 1)
            np.add.at(written, idx, 1)
            for i in np.nonzero(live_c & ~full)[0]:  # the tail
                k = n - c[i]
                out[rw[i] + c[i]:rw[i] + n] = 255 * ((run[i] >> np.arange(k)) & 1)
                written[rw[i] + c[i]:rw[i] + n] += 1
    return out, written


def _blocks(planes, nwr, nseg):
    """(plane, word row of the plane, row part, c0) of every block."""
    p, bx = np.meshgrid(np.arange(planes), np.arange(nwr * NRH * nseg), indexing="ij")
    p, bx = p.ravel(), bx.ravel()
    kr = bx // nseg
    return p, kr // NRH, kr % NRH, (bx % nseg) * SEG


def model_unpack(f: np.ndarray, h: int, index=None, base: int = 0) -> np.ndarray:
    """(B, ceil(h/32), w) int32 planes -> (B, h, w) uint8 maps, as
    ``unpack_kernel`` writes them; ``base`` is the maps' address modulo 16."""
    nb, hw, w = f.shape
    to = np.arange(nb) if index is None else np.asarray(index, np.int64)
    p, k, rpart, c0 = _blocks(nb, hw, -(-w // SEG))
    keep = (to[p] >= 0) & (to[p] < nb)  # an index outside [0, B) writes nothing
    p, k, rpart, c0 = p[keep], k[keep], rpart[keep], c0[keep]

    def row_at(b, j):
        r = 32 * k[b] + j
        return np.where(r < h, (to[p[b]] * h + r) * w, -1)

    words = f.view(np.uint32).astype(np.int64).reshape(nb * hw, w)
    out, written = model_runs(words, w, p * hw + k, rpart, c0, row_at, nb * h * w, base)
    out, written = out.reshape(nb, h, w), written.reshape(nb, h, w)
    mapped = np.isin(np.arange(nb), to)
    assert (written[mapped] == 1).all(), "a byte was not written exactly once"
    assert (written[~mapped] == 0).all()
    return out


def model_unpack_core(f: np.ndarray, t: Tiling, base: int = 0) -> np.ndarray:
    """(B ny nx, ceil(ext_h/32), ext_w) int32 planes -> (B, ny h_loc, nx
    w_loc) uint8 maps, as ``unpack_core_kernel`` writes them."""
    tiles, hwe, ew = f.shape
    nb, oh, ow = tiles // t.tiles, t.ny * t.h_loc, t.nx * t.w_loc
    k0 = t.e_top // 32
    nwr = (t.e_top + t.h_loc - 1) // 32 - k0 + 1
    tt, kr, rpart, c0 = _blocks(tiles, nwr, -(-t.w_loc // SEG))
    k = k0 + kr
    b, ti, tj = tt // t.tiles, (tt // t.nx) % t.ny, tt % t.nx

    def row_at(blk, j):
        r = 32 * k[blk] + j - t.e_top
        start = (b[blk] * oh + ti[blk] * t.h_loc + r) * ow + tj[blk] * t.w_loc
        return np.where((r >= 0) & (r < t.h_loc), start, -1)

    words = f.view(np.uint32).astype(np.int64)[:, :, t.e_left:t.e_left + t.w_loc]
    out, written = model_runs(words.reshape(tiles * hwe, t.w_loc), t.w_loc, tt * hwe + k, rpart,
                              c0, row_at, nb * oh * ow, base)
    assert (written == 1).all(), "a byte was not written exactly once"
    return out.reshape(nb, oh, ow)


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


def _tiling(ny, nx, h_loc, w_loc, e_top, e_left, below=3, right=5):
    return Tiling(ny, nx, h_loc, w_loc, e_top, e_left, e_top + h_loc + below,
                  e_left + w_loc + right, (ny * h_loc, nx * w_loc))


#: (ny, nx, h_loc, w_loc, e_top, e_left): bit offsets e_top % 32 of 0, 1 and
#: 31 (and 32, 33: a first word row past the plane's first); lane offsets;
#: core widths and pitches that are not multiples of 16, so heads and tails
#: fall at every column split; one row and one column; two segments.
CORES = [
    (2, 3, 45, 37, 0, 0), (2, 3, 45, 37, 1, 5), (2, 3, 45, 37, 31, 64), (1, 2, 70, 53, 32, 3),
    (3, 2, 33, 17, 33, 17), (2, 2, 31, 15, 31, 1), (1, 4, 1, 1, 1, 0), (4, 1, 8, 96, 8, 0),
    (1, 3, 40, 21, 16, 48), (2, 1, 64, 1100, 31, 7), (1, 2, 5, 1030, 0, 1),
]


@pytest.mark.parametrize("core", CORES)
def test_core_layout_matches_plain(core):
    t = _tiling(*core)
    rng = np.random.default_rng(sum(core))
    nb = 2
    f = rng.integers(-2**31, 2**31, (nb * t.tiles, -(-t.ext_h // 32), t.ext_w),
                     dtype=np.int64).astype(np.int32)
    want = unpack_core_plain(torch.from_numpy(f), torch.full(
        (nb, t.ny * t.h_loc, t.nx * t.w_loc), 7, dtype=torch.uint8), t).numpy()
    assert not (want == 7).any()
    np.testing.assert_array_equal(model_unpack_core(f, t), want)
    if t.w_loc * t.nx <= 300:  # the heads at every start: maps at an unaligned address
        for base in (1, 9, 15):
            np.testing.assert_array_equal(model_unpack_core(f, t, base=base), want)


@pytest.mark.parametrize("core", [CORES[1], CORES[2], CORES[4], CORES[7]])
def test_core_layout_matches_pallas(core):
    """Tile by tile against the JAX package's core unpack in interpret mode,
    on planes padded to its granules (bits past the extended tile clear)."""
    t = _tiling(*core)
    hw = -(-t.ext_h // 32)
    rng = np.random.default_rng(7 + sum(core))
    words = rng.integers(0, 2**32, (t.tiles, hw, t.ext_w), dtype=np.uint64).astype(np.uint32)
    if t.ext_h % 32:
        words[:, -1] &= np.uint32((1 << (t.ext_h % 32)) - 1)
    got = model_unpack_core(words.view(np.int32), t)[0]
    for tile in range(t.tiles):
        i, j = tile // t.nx, tile % t.nx
        padded = np.zeros((-(-(hw + 1) // 8) * 8, -(-t.ext_w // 128) * 128 + 128), np.uint32)
        padded[:hw, :t.ext_w] = words[tile]
        want = unpack_core_call(jnp.asarray(padded), t.e_top, t.e_left, t.h_loc, t.w_loc,
                                interpret=True)
        np.testing.assert_array_equal(
            got[i * t.h_loc:(i + 1) * t.h_loc, j * t.w_loc:(j + 1) * t.w_loc], np.asarray(want))


def test_the_core_wrapper_on_the_cpu_is_the_plain_version():
    t = _tiling(*CORES[2])
    f = torch.from_numpy(np.random.default_rng(3).integers(
        -2**31, 2**31, (t.tiles, -(-t.ext_h // 32), t.ext_w), dtype=np.int64).astype(np.int32))
    shape = (1, t.ny * t.h_loc, t.nx * t.w_loc)
    got = unpack_core(f, torch.zeros(shape, dtype=torch.uint8), t)
    assert torch.equal(got, unpack_core_plain(f, torch.zeros(shape, dtype=torch.uint8), t))
