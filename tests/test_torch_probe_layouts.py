"""NumPy models of the schedules of K13's packs and resident loop
(``cudacam_tpu_torch/csrc/probe_hyster.cu``) against the contracts.

The kernels run only on a card (``tests/test_torch_cuda.py``). Here each
kernel's work split is written out in NumPy with the kernel's own indices,
and what it computes is held to independent references, tolerance 0 (bit
masks and integers):

* the resident loop (``loop_block_kernel``): one block, its threads
  holding up to R rows of one column; a round from a thread's own rows, the
  next lane's column (a shuffle) or a warp's published column, and the row
  above from the thread above's published last row or, at a thread's first
  row in the top group, the last group's (the plane's last row, cyclic);
  published rows and columns alternating between two buffers that start as
  garbage; lanes past w and rows past the plane left unmasked in full
  groups, shown to stay 0. Held to ``_loop_numpy``, to ``probe_loop_plain``
  and to the JAX probe kernel in interpret mode;
* the ballot pack (``pack_ballot_kernel``): warp tasks of one word row x 32
  columns, a lane's row read as two 16-byte vectors where the row's
  address is 16-byte aligned and the 32 columns lie inside w, else byte by
  byte; rows past h as 0; the ballot as bit assembly over lanes. Held to
  the JAX ``bitpack.pack_mask`` and to the recorded outputs of JAX probe A';
* the shared-memory pack (``pack_tile_kernel``): 32-row x 512-column tiles,
  a warp staging 512 bytes of a row a step: 16 bytes a lane where the row's
  address is 16-byte aligned (copied by ``cp.async`` on the vector route),
  else aligned 4-byte words cut by a funnel shift, the next word from the
  next lane; unchecked loads where the segment and a word either side lie
  inside the mask (tile columns past w reach no stored word), checked
  words elsewhere, bytes only at the mask's own ends, no load outside the
  mask; a thread's 4 columns by the SWAR normaliser and the
  ``__byte_perm`` transpose as uint32 arithmetic, 16-byte stores where the
  words' address allows; every tile byte and output word written once.
  Held to ``bitpack.pack_mask``, ``probe_pack_plain``, the recorded output
  of JAX probe A and ``probe_pack_layout``;
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cudacam_tpu.ops.bitpack import pack_mask
from cudacam_tpu_torch.probes import hyster_kernel as hk
from cudacam_tpu_torch.probes import i16_swar
from test_torch_probes import _loop_numpy, hyster_calls, swar_calls  # noqa: F401 (fixtures)

#: The kernel's constants: a block's threads and a thread's rows at most.
LOOP_NT, LOOP_R = 1024, 10


def _resident_plan(hw: int, w: int):
    """``probe_loop_plan``'s resident route: (rows a thread R, row groups
    G, columns tw), or None where one block does not hold the plane."""
    tw = -(-w // 32) * 32
    if w > LOOP_NT:
        return None
    rows = -(-hw // (LOOP_NT // tw))
    if rows > LOOP_R:
        return None
    return rows, -(-hw // rows), tw


def _resident_loop(plane: np.ndarray, max_rounds: int, seed: int = 0):
    """The resident loop's schedule: returns (plane, [[rounds, changed]]).
    Every published buffer starts as garbage."""
    hw, w = plane.shape
    R, G, tw = _resident_plan(hw, w)
    n = G * tw
    t = np.arange(n)
    g, c, lane = t // tw, t % tw, t % 32
    mine = np.where(c < w, np.clip(hw - g * R, 0, R), 0)
    partial = (g + 1) * R > hw  # the last group
    r = np.arange(R)
    valid = r[None, :] < mine[:, None]  # (n, R)
    src_rows = np.minimum(g[:, None] * R + r, hw - 1)
    f32 = plane.view(np.uint32)
    regs = np.where(valid, f32[src_rows, np.minimum(c, w - 1)[:, None]], 0).astype(np.uint32)

    # Sources: the row above row 0 (the group above's published last row, at
    # g = 0 the last group's), and the column right of c.
    up = np.where(g > 0, g - 1, G - 1) * tw + c
    wrap = c == w - 1
    from_edge = (mine > 0) & ((lane == 31) | wrap)
    src_warp = np.minimum(g * (tw // 32) + np.where(wrap, 0, (c + 1) // 32), n // 32 - 1)
    nxt = np.where(lane < 31, t + 1, t)  # __shfl_down_sync: lane 31 reads its own word

    rng = np.random.default_rng(seed)
    last = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    edge = rng.integers(0, 2**32, (2, n // 32, R), dtype=np.uint64).astype(np.uint32)

    def publish(buf):
        row = np.where(partial, np.maximum(mine - 1, 0), R - 1)
        last[buf] = regs[t, row]
        edge[buf] = regs[::32, :]  # lane 0 of each warp

    publish(0)
    it = 0
    while True:
        buf = it & 1
        right = np.where(from_edge[:, None], edge[buf][src_warp], regs[nxt, :])
        above = np.concatenate([last[buf][up][:, None], regs[:, :-1]], axis=1)
        nv = regs | above | right | (regs << np.uint32(1))
        nv = np.where(partial[:, None] & ~valid, 0, nv)  # a full group's rows are all kept
        changed = bool((nv ^ regs).any())
        regs = nv
        publish(buf ^ 1)
        it += 1
        if not changed or it >= max_rounds:
            break
    assert not regs[~valid].any()  # lanes past w and rows past the plane stay 0
    out = np.zeros((hw, w), np.uint32)
    ti, ri = np.nonzero(valid)
    out[g[ti] * R + ri, c[ti]] = regs[ti, ri]
    return out.view(np.int32), [[it, int(changed)]]


def _sparse(hw: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (3, hw, w), dtype=np.uint64).astype(np.uint32)
    return (words[0] & words[1] & words[2]).view(np.int32)


#: Small and odd planes, and the tallest plane the resident route takes at
#: 256, 100, 32 and 1024 columns (every thread at 10 rows).
LOOP_PLANES = [(40, 256), (1, 1), (7, 9), (33, 5), (3, 40), (1, 77), (45, 1), (80, 100),
               (320, 32), (10, 1024)]


@pytest.mark.parametrize("shape", LOOP_PLANES)
@pytest.mark.parametrize("cap", [1, 2, 5, 37, 400])
def test_resident_loop_schedule_equals_the_contract(shape, cap):
    for seed, plane in enumerate((hk.loop_input(*shape), _sparse(*shape, seed=sum(shape)))):
        got, flags = _resident_loop(plane, cap, seed)
        want, want_flags = _loop_numpy(plane, cap)
        np.testing.assert_array_equal(got, want)
        assert flags == want_flags
        plain, plain_flags = hk.probe_loop_plain(torch.from_numpy(plane), cap)
        assert torch.equal(plain, torch.from_numpy(got)) and plain_flags.tolist() == flags


def test_resident_loop_plan_holds_the_plane_in_one_block():
    assert _resident_plan(40, 256) == (10, 4, 256)
    assert _resident_plan(41, 256) is None  # one word row past: the grid route
    assert _resident_plan(45, 1) == (2, 23, 32)
    assert _resident_plan(320, 32) == (10, 32, 32)
    assert _resident_plan(321, 32) is None
    assert _resident_plan(10, 1024) == (10, 1, 1024)
    assert _resident_plan(1, 1025) is None


def test_resident_loop_schedule_equals_the_jax_probe(hyster_calls):
    """The JAX kernel in interpret mode, on the probe's own input and on
    the edge planes of its shape."""
    kernel, kw, (plane,), (out, flags) = hyster_calls[2]
    got, got_flags = _resident_loop(plane.view(np.int32), hk.LOOP_ROUNDS)
    np.testing.assert_array_equal(got, out.view(np.int32))
    assert got_flags == np.asarray(flags).tolist() == [[326, 0]]
    corner = np.zeros((40, 256), np.int32)
    corner[39, 255] = 1
    for edge_plane in (corner, _sparse(40, 256, seed=3)):
        jout, jflags = pl.pallas_call(kernel, interpret=True, **kw)(
            jnp.asarray(edge_plane.view(np.uint32)))
        got, got_flags = _resident_loop(edge_plane, hk.LOOP_ROUNDS)
        np.testing.assert_array_equal(got, np.asarray(jout).view(np.int32))
        assert got_flags == np.asarray(jflags).tolist()


def test_resident_loop_garbage_is_never_read():
    """Runs whose published buffers start as different garbage agree:
    every value read was written first."""
    plane = _sparse(40, 256, seed=7)
    runs = [_resident_loop(plane, 400, seed) for seed in range(4)]
    assert all(np.array_equal(runs[0][0], o) and runs[0][1] == fl for o, fl in runs[1:])


# -- the ballot pack --------------------------------------------------------


def _ballot_pack(buf: np.ndarray, offset: int, h: int, w: int):
    """``pack_ballot_kernel`` on the (h, w) mask at ``buf[offset:]``, with
    ``buf`` starting on a 16-byte boundary: (words, how many rows took each
    path)."""
    hw, groups = -(-h // 32), -(-w // 32)
    out = np.zeros((hw, w), np.uint32)
    paths = {"vector": 0, "byte": 0, "past h": 0}
    lanes = np.arange(32, dtype=np.uint32)
    for task in range(hw * groups):  # k-major, as the grid walks them
        k, c0 = divmod(task, groups)
        c0 *= 32
        v = np.zeros((32, 8), np.uint32)
        for lane in range(32):
            y = 32 * k + lane
            addr = offset + y * w + c0
            if y >= h:
                paths["past h"] += 1
            elif c0 + 32 <= w and addr % 16 == 0:
                paths["vector"] += 1
                v[lane] = np.concatenate([buf[addr:addr + 16], buf[addr + 16:addr + 32]]).view("<u4")
            else:
                paths["byte"] += 1
                row = np.zeros(32, np.uint8)
                n = min(32, w - c0)
                row[:n] = buf[addr:addr + n]
                v[lane] = row.view("<u4")
        mine = np.zeros(32, np.uint32)
        for b in range(32):
            pred = ((v[:, b >> 2] >> np.uint32(8 * (b & 3))) & np.uint32(0xFF)) != 0
            word = np.bitwise_or.reduce(pred.astype(np.uint32) << lanes)  # the ballot
            mine[b] = word  # lane b keeps it
        keep = c0 + np.arange(32) < w
        out[k, c0:c0 + 32][:keep.sum()] = mine[keep]
    return out.view(np.int32), paths


def _buffer(h: int, w: int, offset: int, seed: int) -> np.ndarray:
    buf = np.zeros(offset + h * w + 32, np.uint8)
    buf[offset:offset + h * w] = hk.pack_input(seed, h, w).ravel() * np.uint8(3)
    return buf


@pytest.mark.parametrize("h,w", [(128, 256), (1, 1), (37, 53), (70, 1918), (33, 7680 + 16),
                                 (64, 96), (40, 31)])
@pytest.mark.parametrize("offset", [0, 1, 16])
def test_ballot_pack_tasks_equal_pack_mask(h, w, offset):
    buf = _buffer(h, w, offset, seed=h + w)
    mask = buf[offset:offset + h * w].reshape(h, w)
    got, paths = _ballot_pack(buf, offset, h, w)
    np.testing.assert_array_equal(got, np.asarray(pack_mask(jnp.asarray(mask != 0))).view(np.int32))
    assert torch.equal(hk.probe_pack_ballot_plain(torch.from_numpy(mask.copy())),
                       torch.from_numpy(got))
    groups, full = -(-w // 32), w // 32
    rows = min(h, 32 * -(-h // 32))
    assert paths["past h"] == (32 * -(-h // 32) - h) * groups
    if offset % 16 == 0 and w % 16 == 0:
        assert paths["vector"] == rows * full  # every whole task's rows
    if offset % 16 == 1 and w % 16 == 0:
        assert paths["vector"] == 0  # every row's address is off the boundary
    if w == 1918 and offset == 0:
        assert 0 < paths["vector"] < rows * full  # rows alternate between the paths


def test_ballot_pack_tasks_equal_the_jax_probe(hyster_calls):
    _, _, (mask,), (words,) = hyster_calls[1]
    for offset in (0, 1):
        buf = np.zeros(offset + mask.size + 32, np.uint8)
        buf[offset:offset + mask.size] = mask.ravel()
        got, paths = _ballot_pack(buf, offset, *mask.shape)
        np.testing.assert_array_equal(got, words.view(np.int32))
        assert paths["vector" if offset == 0 else "byte"] == mask.shape[0] * mask.shape[1] // 32


# -- the shared-memory pack ----------------------------------------------------

#: The kernel's tile columns, threads a block and staging steps a thread.
PACK_TW, PACK_NT, PACK_STEPS = 512, 128, 8
U32 = np.uint32


def _byte_perm(x, y, sel: int):
    """``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the result is
    byte ``(sel >> 4 i) & 7`` of the 8 bytes y:x."""
    xy = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint32)
    for i in range(4):
        b = (xy >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= b.astype(np.uint32) << U32(8 * i)
    return out


def _swar_words(rows: np.ndarray) -> np.ndarray:
    """A thread's transpose: ``rows`` (32, n) uint32 shared words (4 columns
    each) -> (n, 4) words, by the kernel's SWAR normaliser, shifts and
    ``__byte_perm`` transpose, as uint32 arithmetic."""
    acc = np.zeros((4, rows.shape[1]), np.uint32)
    for r in range(32):
        b = rows[r]
        nz = (((b & U32(0x7F7F7F7F)) + U32(0x7F7F7F7F)) | b) & U32(0x80808080)
        acc[r >> 3] |= nz >> U32(7 - (r & 7))
    t0, t1 = _byte_perm(acc[0], acc[1], 0x5140), _byte_perm(acc[0], acc[1], 0x7362)
    t2, t3 = _byte_perm(acc[2], acc[3], 0x5140), _byte_perm(acc[2], acc[3], 0x7362)
    return np.stack([_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                     _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)], 1)


def _tile_pack(buf: np.ndarray, offset: int, h: int, w: int, gy=None):
    """``pack_tile_kernel`` on the (h, w) mask at ``buf[offset:]`` (a
    16-byte load stands for the vector route's ``cp.async`` copy too), with
    ``buf`` starting on a 16-byte boundary and the output on one (a fresh
    allocation): returns (words, how often each word was written, counts of
    the rows by route, the loads by width and the stores by kind). ``gy``
    (the grid's rows; the kernel's is ``min(hw, 65535)``) exercises the
    word-row loop at small sizes. Every load's address is checked against
    its width and against the mask's bytes, and every tile byte is written
    once a word row."""
    hw = -(-h // 32)
    gx = -(-w // PACK_TW)
    lay = hk.probe_pack_layout(h, w, offset)
    vec = w % 16 == 0 and offset % 16 == 0
    assert lay == dict(route="vector" if vec else "general", threads=PACK_NT,
                       blocks=gx * min(hw, 65535), tile_columns=PACK_TW, columns_per_thread=4,
                       smem_bytes=32 * PACK_TW)
    gy = gy or min(hw, 65535)
    out = np.zeros(hw * w, np.uint32)
    writes = np.zeros(hw * w, np.int32)
    counts = {"rows 16": 0, "rows 4": 0, "rows shifted": 0, "rows past h": 0, "loads 16": 0,
              "loads 4": 0, "loads 1": 0, "stores 16": 0, "stores 4": 0, "checked": 0}
    lane = np.arange(32)
    segs = PACK_TW // 512
    tid = np.arange(PACK_NT)

    def load(addr, width):
        assert (addr % width == 0).all()  # every load on its width's boundary
        assert (addr >= offset).all() and (addr + width <= offset + h * w).all()  # the mask's
        if width == 1:  # bytes only at the mask's own first and last 3 bytes
            assert ((addr - offset < 3) | (offset + h * w - addr <= 3)).all()
        counts[f"loads {width}"] += addr.size
        return buf[addr[..., None] + np.arange(width)] if width > 1 else buf[addr]

    def row_word(row, c):
        """``row_word``: (n,) columns of the row at ``row`` -> (n,) words: 0
        and no load where the word lies wholly past w, one 4-byte load where
        it lies inside the mask (neighbouring rows' bytes and all), else its
        bytes inside [0, w)."""
        c = np.asarray(c)
        assert (c > -4).all()
        cols = c[:, None] + np.arange(4)
        inside = (cols >= 0) & (cols < w)
        got = np.zeros((c.size, 4), np.uint8)
        some = c < w
        word = some & (row + c >= offset) & (row + c + 4 <= offset + h * w)
        if word.any():
            got[word] = load(row + c[word], 4)
        by = some & ~word
        part = got[by]
        part[inside[by]] = load((row + cols[by])[inside[by]], 1)
        got[by] = part
        return got.view("<u4").ravel().astype(np.uint32)

    for bx in range(gx):
        c0 = bx * PACK_TW
        for by in range(gy):
            for k in range(by, hw, gy):
                tile = np.zeros((32, PACK_TW // 4), np.uint32)
                tile_writes = np.zeros((32, PACK_TW // 4), np.int32)
                for warp in range(PACK_NT // 32):
                    seg, r0 = warp % segs, warp // segs
                    cs = c0 + 512 * seg
                    for j in range(PACK_STEPS):
                        r = r0 + 4 * j
                        y = 32 * k + r
                        row = offset + y * w  # the row's address, not its column
                        a = row % 16
                        v = np.zeros((32, 4), np.uint32)  # (lane, q)
                        at = y * w  # the row's offset in the mask
                        # every segment but the mask's first and last: no checks
                        fast = vec or (at + cs - 4 >= 0 and at + cs + 516 <= h * w)
                        counts["checked"] += y < h and not fast
                        if y >= h:
                            counts["rows past h"] += 1
                            place = 4 * lane[:, None] + np.arange(4)  # one 16-byte store
                        elif a == 0:  # 16 bytes from cs + 16 lane
                            counts["rows 16"] += 1
                            c = cs + 16 * lane
                            if fast and vec:  # cp.async: nothing past w
                                live = c < w
                                v[live] = load(row + c[live], 16).reshape(-1, 16).view("<u4")
                            elif fast:
                                v[:] = load(row + c, 16).reshape(-1, 16).view("<u4")
                            else:
                                v = row_word(row, (c[:, None] + 4 * np.arange(4)).ravel())
                                v = v.reshape(32, 4)
                            place = 4 * lane[:, None] + np.arange(4)
                        else:  # aligned words a % 4 bytes before the row's, a funnel shift
                            am = a % 4
                            counts["rows shifted" if am else "rows 4"] += 1
                            cols = cs + 4 * (32 * np.arange(4)[None, :] + lane[:, None]) - am
                            if fast:
                                v = load(row + cols.ravel(), 4).view("<u4").reshape(32, 4)
                                nxt = load(np.array([row + cs + 512 - am]), 4).view("<u4")[0, 0]
                            else:
                                v = row_word(row, cols.ravel()).reshape(32, 4)
                                nxt = row_word(row, [cs + 512 - am])[0]  # lane 31's
                            v = v.astype(np.uint32)
                            if am:
                                hi = np.roll(v, -1, 0)  # __shfl_down_sync: the next lane's
                                hi[31] = np.append(v[0, 1:], nxt)  # lane 0's of q + 1
                                both = (hi.astype(np.uint64) << np.uint64(32)) | v
                                v = (both >> np.uint64(8 * am)).astype(np.uint32)
                            place = 32 * np.arange(4)[None, :] + lane[:, None]
                        tile[r, 128 * seg + place] = v
                        np.add.at(tile_writes[r], (128 * seg + place).ravel(), 1)
                assert (tile_writes == 1).all()  # the staging covers the tile once
                # Inside w the tile holds the mask's rows (0 past h); past w,
                # whatever was loaded: those columns reach no stored word.
                n_in = min(PACK_TW, w - c0)
                rows = 32 * k + np.arange(32)
                want = np.zeros((32, n_in), np.uint8)
                live = rows < h
                want[live] = buf[offset + rows[live, None] * w + c0 + np.arange(n_in)]
                np.testing.assert_array_equal(tile.view(np.uint8)[:, :n_in], want)
                words = _swar_words(tile)  # (threads, 4)
                c = c0 + 4 * tid
                at = k * w + c
                vector = (c + 4 <= w) & ((4 * at) % 16 == 0)
                counts["stores 16"] += int(vector.sum())
                for q in range(4):
                    keep = c + q < w
                    out[at[keep] + q] = words[keep, q]
                    writes[at[keep] + q] += 1
                    counts["stores 4"] += int((keep & ~vector).sum())
    return out.reshape(hw, w).view(np.int32), writes.reshape(hw, w), counts


#: The ballot pack's shapes, and h off 32 at an aligned width.
PACK_SHAPES = [(128, 256), (1, 1), (37, 53), (70, 1918), (33, 7680 + 16), (64, 96), (40, 31),
               (33, 1024)]


@pytest.mark.parametrize("h,w", PACK_SHAPES)
@pytest.mark.parametrize("offset", [0, 1, 4, 8, 16])
def test_tile_pack_equals_pack_mask(h, w, offset):
    buf = _buffer(h, w, offset, seed=h + w)
    mask = buf[offset:offset + h * w].reshape(h, w)
    got, writes, n = _tile_pack(buf, offset, h, w)
    np.testing.assert_array_equal(got, np.asarray(pack_mask(jnp.asarray(mask != 0))).view(np.int32))
    assert torch.equal(hk.probe_pack_plain(torch.from_numpy(mask.copy())), torch.from_numpy(got))
    assert (writes == 1).all()  # every output word written once
    hw, segs = -(-h // 32), -(-w // PACK_TW) * (PACK_TW // 512)  # a row's warp segments
    assert n["rows past h"] == (32 * hw - h) * segs
    assert n["rows 16"] + n["rows 4"] + n["rows shifted"] == h * segs
    assert n["loads 1"] <= 16  # words at the mask's first and last 3 bytes only
    if w % 16 == 0:
        route = {0: "rows 16", 4: "rows 4", 8: "rows 4", 1: "rows shifted"}[offset % 16]
        assert n[route] == h * segs  # every row takes one route
    if w % 16 == 0 and offset % 4 == 0:
        assert n["loads 1"] == 0
    if w % 4 == 0:
        assert n["stores 4"] == 0  # every row's words on a 16-byte boundary
    if w == 1918 and offset == 0:
        assert n["rows 16"] and n["rows 4"] and n["rows shifted"]  # rows take all three
    if h * w > 20000 and not (w % 16 == 0 and offset % 16 == 0):
        assert 0 < n["checked"] < h * segs // 8  # the mask's first and last segments only


@pytest.mark.parametrize("values", [(0x00, 0x01), (0x00, 0x7F), (0x00, 0x80), (0x00, 0xFF),
                                    (0x01, 0x7F, 0x80, 0xFF, 0x00, 0x40, 0x03)])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_tile_pack_normalises_every_byte(values, offset):
    """Masks of the normaliser's edge bytes: bit 7 alone, the low 7 bits
    alone, all bits."""
    h, w = 37, 528
    rng = np.random.default_rng(len(values) * 10 + offset)
    mask = np.asarray(values, np.uint8)[rng.integers(0, len(values), (h, w))]
    buf = np.zeros(offset + h * w + 32, np.uint8)
    buf[offset:offset + h * w] = mask.ravel()
    got, writes, _ = _tile_pack(buf, offset, h, w)
    np.testing.assert_array_equal(got, np.asarray(pack_mask(jnp.asarray(mask != 0))).view(np.int32))
    assert (writes == 1).all()


def test_tile_pack_swar_equals_the_bit_sum():
    """The normaliser over all 256 byte values at every row position, and
    the byte transpose, against the direct bit sum."""
    rng = np.random.default_rng(0)
    cols = np.concatenate([np.repeat(np.arange(256, dtype=np.uint8)[None], 32, 0),
                           rng.integers(0, 256, (32, 256), dtype=np.uint8)], 1)
    words = _swar_words(cols.view("<u4").astype(np.uint32)).ravel()
    want = ((cols != 0).astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None]).sum(0)
    np.testing.assert_array_equal(words, want.astype(np.uint32))


def test_tile_pack_word_row_loop():
    """A grid with fewer rows than word rows (the kernel's past 65535)
    walks every word row once."""
    h, w = 32 * 5 + 3, 1100
    buf = _buffer(h, w, 4, seed=9)
    mask = buf[4:4 + h * w].reshape(h, w)
    for gy in (1, 2, 3):
        got, writes, _ = _tile_pack(buf, 4, h, w, gy=gy)
        np.testing.assert_array_equal(got, np.asarray(pack_mask(jnp.asarray(mask != 0)))
                                      .view(np.int32))
        assert (writes == 1).all()
    assert hk.probe_pack_layout(32 * 70000, 16)["blocks"] == 65535
    assert hk.probe_pack_layout(32 * 70000, 1030)["blocks"] == 3 * 65535


def test_tile_pack_equals_the_jax_probe(hyster_calls):
    """The probe's own mask and words (TPU probe A in interpret mode), on
    both routes."""
    _, _, (mask,), (words,) = hyster_calls[0]
    for offset in (0, 1, 4):
        buf = np.zeros(offset + mask.size + 32, np.uint8)
        buf[offset:offset + mask.size] = mask.ravel()
        got, writes, n = _tile_pack(buf, offset, *mask.shape)
        np.testing.assert_array_equal(got, words.view(np.int32))
        assert (writes == 1).all()
        assert n[{0: "rows 16", 1: "rows shifted", 4: "rows 4"}[offset]] == mask.shape[0]


# -- the byte-mode unpack's runs ---------------------------------------------


def _unpack_runs(f: np.ndarray, f_offset: int, out_offset: int, seed: int = 0):
    """``unpack_runs_kernel`` on (hw, w) words whose first word lies
    ``f_offset`` bytes past a 16-byte boundary, into an output buffer whose
    first byte lies ``out_offset`` bytes past one (garbage before it and
    beyond, as an allocator leaves it): returns (the (32 hw, w) map, how
    often each output byte was written, the bytes before and after the map,
    counts of the paths taken)."""
    hw, w = f.shape
    lay = hk.probe_unpack_layout(hw, w, per_word=False)
    runs = -(-w // 16)  # a row's runs at most
    gx, gy = -(-runs // 8), min(hw, 65535)
    assert lay == dict(route="runs", threads=256, blocks=gx * gy, bytes_per_thread=16)
    rng = np.random.default_rng(seed)
    n = 32 * hw * w
    out = rng.integers(0, 256, out_offset + n + 16, dtype=np.uint8)
    writes = np.zeros_like(out, dtype=np.int32)
    paths = {"vector loads": 0, "word loads": 0, "runs": 0, "head bytes": 0, "tail bytes": 0}
    fw = f.view(np.uint32)
    tid = np.arange(gx * 256)
    bx, t = tid // 256, tid % 256
    lane, warp = t % 32, t // 32
    j = 8 * (warp & 3) + (lane >> 2)
    m = 8 * bx + 4 * (warp >> 2) + (lane & 3)
    assert len(set(zip(j.tolist(), m.tolist()))) == len(tid)  # one thread a (row, run)

    def byte(k, r, c):
        return 255 if (int(fw[k, c]) >> r) & 1 else 0

    for by in range(gy):
        k = by
        while k < hw:
            row = out_offset + (32 * k + j) * w  # the rows' first bytes
            d = (16 - row % 16) % 16
            for i in np.flatnonzero(m == 0):  # heads
                for c in range(min(int(d[i]), w)):
                    out[row[i] + c] = byte(k, j[i], c)
                    writes[row[i] + c] += 1
                    paths["head bytes"] += 1
            c = d + 16 * m
            for i in np.flatnonzero((c < w) & (c + 16 > w)):  # tails
                for cc in range(int(c[i]), w):
                    out[row[i] + cc] = byte(k, j[i], cc)
                    writes[row[i] + cc] += 1
                    paths["tail bytes"] += 1
            full = np.flatnonzero(c + 16 <= w)
            if full.size:
                at = row[full] + c[full]
                assert (at % 16 == 0).all()  # every 16-byte store on its boundary
                word_at = f_offset + 4 * (k * w + c[full])
                vec = word_at % 16 == 0
                paths["vector loads"] += 4 * int(vec.sum())
                paths["word loads"] += 16 * int((~vec).sum())
                paths["runs"] += full.size
                cols = c[full, None] + np.arange(16)
                bits = (fw[k][cols] >> j[full, None].astype(np.uint32)) & np.uint32(1)
                packed = (bits << np.arange(16, dtype=np.uint32)).sum(1)
                nib = [(packed >> np.uint32(4 * q)) & np.uint32(15) for q in range(4)]
                words = np.stack([((x * np.uint32(0x00204081)) & np.uint32(0x01010101))
                                  * np.uint32(0xFF) for x in nib], 1).astype("<u4")
                idx = at[:, None] + np.arange(16)
                out[idx] = words.view(np.uint8).reshape(-1, 16)
                np.add.at(writes, idx.ravel(), 1)
            k += gy
    outside = np.concatenate([out[:out_offset], out[out_offset + n:]])
    return (out[out_offset:out_offset + n].reshape(32 * hw, w),
            writes[out_offset:out_offset + n], outside, paths)


UNPACK_PLANES = [(4, 256), (1, 1), (2, 53), (1, 70), (1, 1918), (2, 17), (1, 4), (3, 16),
                 (1, 33), (2, 7680 + 4)]


@pytest.mark.parametrize("hw,w", UNPACK_PLANES)
@pytest.mark.parametrize("f_offset,out_offset", [(0, 0), (4, 0), (0, 3), (8, 15)])
def test_unpack_runs_write_every_byte_once(hw, w, f_offset, out_offset):
    f = np.random.default_rng(hw * 100 + w).integers(0, 2**32, (hw, w), dtype=np.uint64)
    f = f.astype(np.uint32).view(np.int32)
    rng_before = np.random.default_rng(1).integers(0, 256, out_offset + 32 * hw * w + 16,
                                                   dtype=np.uint8)
    got, writes, outside, paths = _unpack_runs(f, f_offset, out_offset, seed=1)
    assert (writes == 1).all()
    np.testing.assert_array_equal(  # the garbage around the map is untouched
        outside, np.concatenate([rng_before[:out_offset], rng_before[out_offset + got.size:]]))
    assert torch.equal(torch.from_numpy(got.copy()),
                       hk.probe_unpack_plain(torch.from_numpy(f.copy()), per_word=False))
    n = 32 * hw * w
    assert paths["head bytes"] + paths["tail bytes"] + 16 * paths["runs"] == n
    if w % 16 == 0 and out_offset % 16 == 0:
        assert paths["head bytes"] == 0  # every row starts on a boundary
    if f_offset % 16 == 0 and w % 16 == 0 and out_offset == 0:
        assert paths["word loads"] == 0 and paths["tail bytes"] == 0
    if f_offset % 16 == 4 and w % 4 == 0 and out_offset == 0 and w % 16 == 0:
        assert paths["vector loads"] == 0  # every run's words off the boundary


def test_unpack_runs_equal_the_jax_probe(hyster_calls):
    """The probe's own words and map (TPU probe E in interpret mode)."""
    _, _, (words,), (out,) = hyster_calls[3]
    for f_offset, out_offset in ((0, 0), (4, 5)):
        got, writes, _, _ = _unpack_runs(words.view(np.int32), f_offset, out_offset)
        np.testing.assert_array_equal(got, out)
        assert (writes == 1).all()


# -- K14's two routes --------------------------------------------------------

M16 = np.uint64(0xFFFF)


def _vadd2(a, b):
    """``__vadd2`` on words held in uint64: two 16-bit lanes, each wrapping."""
    return ((a & M16) + (b & M16)) & M16 | (((a >> np.uint64(16)) + (b >> np.uint64(16))) & M16) \
        << np.uint64(16)


def _left_of(a, b):
    """``__byte_perm(a, b, 0x5432)``: a's high lane low, b's low lane high."""
    return (a >> np.uint64(16)) | ((b & M16) << np.uint64(16))


def _lane(word, half):
    """Lane ``half`` of a word, sign-extended to int64."""
    v = (word >> np.uint64(16 * half)) & M16
    return v.astype(np.uint16).view(np.int16).astype(np.int64)


def _bits16(x: np.ndarray) -> np.ndarray:
    """The 16 bits the kernel reads of each value (u8 zero-extended)."""
    return (x.view(np.uint16) if x.dtype == np.int16 else x).astype(np.uint64)


def _swar_vector(x: np.ndarray, offset: int, body: int, swar: bool, seed: int = 0):
    """``swar_vec_kernel`` on the (h, w) plane x whose first byte lies
    ``offset`` bytes past a 16-byte boundary: the grid's row loop, a
    thread's 8 columns from one vector load a row (each load's and store's
    address checked against its width), the column before and after a
    chunk from the neighbouring lanes or, at a warp's edge lanes and the
    plane's last chunk, a load; lanes past w hold garbage, which no live
    lane may read and no store may write; the results staged a warp at a
    time and stored as 16-byte quads, lane l taking quads l and 32 + l of
    its warp's 256 columns. Returns (out, writes, edge loads)."""
    h, w = x.shape
    esz = x.itemsize
    gx, gy = -(-w // 256), min(-(-h // 8), 65535)
    lay = i16_swar.swar_layout(h, w, body, offset)
    assert lay == dict(route="vector", threads=256, blocks=gx * gy, columns_per_thread=8)
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.int32)
    writes = np.zeros((h, w), np.int32)
    edge_loads = 0
    bits = _bits16(x)
    t = np.arange(gx * 32)  # the threads of one row: (bx, lane), warp-major
    lane, c0 = t % 32, 8 * t
    live = c0 < w
    load_left, load_right = lane == 0, (lane == 31) | (c0 + 8 == w)
    lc, rc = np.where(c0 == 0, w - 1, c0 - 1), np.where(c0 + 8 == w, 0, c0 + 8)
    rows_body, cols_body = body in (2, 4), body in (3, 4)
    cols8 = np.minimum(c0[:, None] + np.arange(8), w - 1)
    for by in range(gy):
        for warp in range(8):
            i = by * 8 + warp
            while i < h:
                up, dn = (i - 1) % h, (i + 1) % h
                assert ((offset + (i * w + c0[live]) * esz) % (8 * esz) == 0).all()  # the load
                src = (i, up, dn) if rows_body else (i,)
                chunk = [np.where(live[:, None], bits[r][cols8],
                                  rng.integers(0, 2**16, (len(t), 8)).astype(np.uint64))
                         for r in src]
                # The 16 bits before and after a chunk, where a lane loads them.
                el = [np.where(live & load_left, bits[r][np.minimum(lc, w - 1)], 0) for r in src]
                er = [np.where(live & load_right, bits[r][np.minimum(rc, w - 1)], 0) for r in src]
                if cols_body:
                    edge_loads += len(src) * int((live & load_left).sum()
                                                 + (live & load_right).sum())
                if swar:
                    words = [[c[:, 2 * q] | (c[:, 2 * q + 1] << np.uint64(16)) for q in range(4)]
                             for c in chunk]
                    s = words[0]
                    if rows_body:
                        s = [_vadd2(_vadd2(words[0][q], words[1][q]), words[2][q])
                             for q in range(4)]
                    if cols_body:
                        fl = s[3] >> np.uint64(16)
                        fr = s[0] & M16
                        fl = np.where(lane > 0, np.roll(fl, 1), fl)  # __shfl_up_sync
                        fr = np.where(lane < 31, np.roll(fr, -1), fr)  # __shfl_down_sync
                        p = np.where(load_left, sum(el) & M16, fl) << np.uint64(16)
                        n = np.where(load_right, sum(er) & M16, fr)
                        y = []
                        for q in range(4):
                            l = _left_of(p if q == 0 else s[q - 1], s[q])
                            r = _left_of(s[q], n if q == 3 else s[q + 1])
                            lw = _vadd2(_vadd2(l, l), l) if body == 3 else l
                            y.append(_vadd2(_vadd2(_vadd2(s[q], s[q]), lw), r))
                    elif body == 1:
                        y = [_vadd2(_vadd2(_vadd2(v, v), v), _vadd2(_vadd2(v, v), _vadd2(v, v)))
                             for v in s]
                    else:
                        y = s
                    res = np.stack([_lane(y[k // 2], k % 2) for k in range(8)], 1)
                else:
                    v = sum(_lane(c, 0) for c in chunk)
                    if cols_body:
                        fl = np.where(lane > 0, np.roll(v[:, 7], 1), v[:, 7])
                        fr = np.where(lane < 31, np.roll(v[:, 0], -1), v[:, 0])
                        l0 = np.where(load_left, sum(_lane(e, 0) for e in el), fl)
                        r7 = np.where(load_right, sum(_lane(e, 0) for e in er), fr)
                        left = np.concatenate([l0[:, None], v[:, :7]], 1)
                        right = np.concatenate([v[:, 1:], r7[:, None]], 1)
                        res = 2 * v + (3 * left if body == 3 else left) + right
                    else:
                        res = 7 * v if body == 1 else v
                    res = res.astype(np.int16).astype(np.int64)
                # The warp's stage: its 256 results in column order; lane l
                # stores quads l and 32 + l, each 16 bytes on a boundary.
                stage = res.reshape(gx, 64, 4)
                for q in (lane, 32 + lane):
                    col = 256 * (t // 32) + 4 * q
                    st = col < w
                    assert ((4 * (i * w + col[st])) % 16 == 0).all()
                    for k in np.flatnonzero(st):
                        out[i, col[k]:col[k] + 4] = stage[k // 32, q[k]]
                        writes[i, col[k]:col[k] + 4] += 1
                i += gy * 8
    return out, writes, edge_loads


def _swar_pairs(x: np.ndarray, offset: int, body: int, swar: bool):
    """``swar_pair_kernel`` on the (h, w) plane x at ``offset``: a column
    pair a thread, the grid's row loop, a pair read as one word only where
    ``w`` is even and the base aligned to a pair (every such load's address
    checked), else lane by lane. Returns (out, writes, word loads)."""
    h, w = x.shape
    esz = x.itemsize
    npair = (w + 1) // 2
    gx, gy = -(-npair // 256), min(h, 65535)
    assert i16_swar.swar_layout(h, w, body, offset) == dict(
        route="general", threads=256, blocks=gx * gy, columns_per_thread=2)
    pairs = w % 2 == 0 and offset % (2 * esz) == 0
    bits = _bits16(x)
    out = np.zeros((h, w), np.int32)
    writes = np.zeros((h, w), np.int32)
    word_loads = 0
    j = 2 * np.arange(gx * 256)
    j = j[j < w]

    def pair(i, jj):
        nonlocal word_loads
        jj = jj % w
        if pairs:
            assert ((offset + (i * w + jj) * esz) % (2 * esz) == 0).all()
            word_loads += len(jj)
        return bits[i][jj] | (bits[i][(jj + 1) % w] << np.uint64(16))

    def val(i, jj):
        return bits[i][jj % w].astype(np.uint16).view(np.int16).astype(np.int64)

    for by in range(gy):
        i = by
        while i < h:
            up, dn = (i - 1) % h, (i + 1) % h
            if swar:
                if body == 1:
                    v = pair(i, j)
                    t2 = _vadd2(v, v)
                    y = _vadd2(_vadd2(t2, v), _vadd2(t2, t2))
                elif body == 2:
                    y = _vadd2(_vadd2(pair(i, j), pair(up, j)), pair(dn, j))
                elif body == 3:
                    p, c, n = pair(i, j - 2), pair(i, j), pair(i, j + 2)
                    l, r = _left_of(p, c), _left_of(c, n)
                    y = _vadd2(_vadd2(_vadd2(c, c), _vadd2(_vadd2(l, l), l)), r)
                else:
                    v = [_vadd2(_vadd2(pair(i, j + 2 * dd), pair(up, j + 2 * dd)),
                                pair(dn, j + 2 * dd)) for dd in (-1, 0, 1)]
                    y = _vadd2(_vadd2(_vadd2(v[1], v[1]), _left_of(v[0], v[1])),
                               _left_of(v[1], v[2]))
                r0, r1 = _lane(y, 0), _lane(y, 1)
            else:
                def body_i32(jj):
                    if body == 1:
                        return 7 * val(i, jj)
                    if body == 2:
                        return val(i, jj) + val(up, jj) + val(dn, jj)
                    if body == 3:
                        return 2 * val(i, jj) + 3 * val(i, jj - 1) + val(i, jj + 1)
                    v = [val(i, jj + dd) + val(up, jj + dd) + val(dn, jj + dd) for dd in (-1, 0, 1)]
                    return 2 * v[1] + v[0] + v[2]
                r0, r1 = body_i32(j).astype(np.int16), body_i32(j + 1).astype(np.int16)
            out[i, j] = r0
            writes[i, j] += 1
            second = j + 1 < w
            out[i, j[second] + 1] = r1[second]
            writes[i, j[second] + 1] += 1
            i += gy
    return out, writes, word_loads


def _stencil_input(shape, body: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, shape, np.uint8) if body == 4
            else rng.integers(-2**15, 2**15, shape, np.int16))  # wrapping lanes included


SWAR_PLANES = [(16, 512), (9, 8), (3, 264), (2, 2056), (1, 1), (7, 9), (3, 513), (2, 6), (5, 12),
               (1, 16)]


@pytest.mark.parametrize("shape", SWAR_PLANES)
@pytest.mark.parametrize("body", [1, 2, 3, 4])
def test_swar_routes_write_every_output_once(shape, body):
    """Both routes, both modes, at the input's offsets 0, one element and
    8 bytes from a 16-byte boundary: the route the mirror names is the one
    whose loads fit the addresses, every output is written once and equals
    the plain version; the vector route loads edge values only at a warp's
    first and last lane and the plane's last chunk."""
    x = _stencil_input(shape, body, seed=shape[0] * 7 + shape[1] + body)
    want = i16_swar.swar_stencil_plain(torch.from_numpy(x), body).numpy()
    h, w = shape
    for offset in (0, x.itemsize, 8):
        vector = w % 8 == 0 and offset % (8 if body == 4 else 16) == 0
        assert i16_swar.swar_layout(h, w, body, offset)["route"] == ("vector" if vector
                                                                     else "general")
        for swar in (True, False):
            if vector:
                got, writes, edges = _swar_vector(x, offset, body, swar, seed=offset)
                if body in (3, 4):  # per row and source row: two a warp (first, last live lane)
                    assert edges == (3 if body == 4 else 1) * 2 * -(-w // 256) * h
            else:
                got, writes, loads = _swar_pairs(x, offset, body, swar)
                assert (loads > 0) == (swar and w % 2 == 0 and offset % (2 * x.itemsize) == 0)
            assert (writes == 1).all(), (offset, swar)
            np.testing.assert_array_equal(got, want, err_msg=f"offset {offset} swar {swar}")


def test_swar_routes_equal_the_jax_probe(swar_calls):
    """The probe's own planes and outputs (TPU probe P1-P4 in interpret
    mode) through the vector route, and the general route one element
    off the boundary."""
    for body, (_, _, (x,), (out,)) in enumerate(swar_calls, 1):
        for swar in (True, False):
            np.testing.assert_array_equal(_swar_vector(x, 0, body, swar)[0], out)
            np.testing.assert_array_equal(_swar_pairs(x, x.itemsize, body, swar)[0], out)


def test_swar_layout_mirror_rows_past_the_grid():
    """Planes taller than 65535 blocks of rows take the grid's row loop."""
    assert i16_swar.swar_layout(65535 * 8 + 8, 8, 1)["blocks"] == 65535
    assert i16_swar.swar_layout(70000, 9, 1)["blocks"] == 65535
    assert hk.probe_unpack_layout(70000, 16, per_word=False)["blocks"] == 65535
