"""The piece walk of the ``ff_pack`` kernel (``csrc/ff_pack.cu`` on the
pieces of ``csrc/ff_walk.cuh``) as a NumPy model, against ``ff_pack_plain``.

The kernel cuts each extended tile into pieces of ``PH`` rows x ``PW``
columns (``NWARP`` warps of 28 packed columns; lanes 0, 1, 30 and 31 only
feed their neighbours), numbered piece by piece within a tile, tile by tile
within the launch, and a persistent grid of blocks walks them: block i takes
pieces i, i + grid, .... A block stages the piece's source window (the
piece, R = KS/2 + 2 halo rows each side, KS/2 + 2 halo columns each side)
by one of two asynchronous copies: the TMA route reads a box of 32-bit words
from the 16-byte boundary at or left of the window's first byte (a box must
start 16-byte aligned; pixels outside the source read 0), the cp.async route 16-byte chunks from the aligned address
at or before each row's first pixel, only chunks that hold bytes of the
row. The window becomes a mono plane (0 outside the image and outside the
source); each thread then walks one column of one word row of the piece (a
row group; PH / 32 of them) down its window's rows: the Gaussian's
row sums (separable for 3 and 7, three row filters for 5), the blur, the
Sobel row terms of the blur with its lane neighbours, the magnitude, the NMS
from the three rows of magnitudes at its lane neighbours, and the class
bits of its 32 rows (zero on the ring, past EH and outside the image),
stored as one packed word.

The model below is that walk, step for step, vectorised over pieces and
lanes; the tests hold it to ``ff_pack_plain`` (which the port's other tests
hold to the JAX package) for whole frames and the export tilings of
``tests/test_torch_cuda.py::SHARDED``, on both routes, and every word of
every plane is written exactly once. The arithmetic forms of the walk are
held to the 2-D taps with floor division on random, all-0 and all-255 mono
tiles, with the ranges that let the kernel keep mono in bytes.

Tolerance: 0. Every value is a packed word or an integer stage value.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudacam_tpu.config import GAUSSIAN_TAPS as JAX_TAPS
from cudacam_tpu_torch import CannyConfig
from cudacam_tpu_torch.config import GAUSSIAN_TAPS
from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame
from cudacam_tpu_torch.ops.cuda.feedforward import Tiling, ff_pack_plain
from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh

torch.set_num_threads(2)

_SRC = Path(__file__).resolve().parents[1] / "cudacam_tpu_torch" / "csrc" / "ff_walk.cuh"


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text()).group(1))


#: The kernel's piece geometry, read from its source so the model follows it.
PH, NWARP, LANES_OUT = _const("PH"), _const("NWARP"), _const("LANES_OUT")
PW, NL, NRG = NWARP * LANES_OUT, NWARP * 32, PH // 32
KSUM = {3: 16, 5: 159, 7: 4096}
TG22, TG67 = 13573, 79109
GARBAGE = 0xA5  # bytes a route leaves unset, or outside the frames' buffer

# -- the arithmetic forms -----------------------------------------------------


def gauss_row(taps, ks):
    """``Gauss<KS>::row``: the row sums of one mono row; ``taps`` (..., KS)
    holds the KS pixels left to right. Returns (..., kHN)."""
    m = [taps[..., i].astype(np.int64) for i in range(ks)]
    if ks == 3:
        return (m[0] + 2 * m[1] + m[2])[..., None]
    if ks == 5:
        ae, bd, c = m[0] + m[4], m[1] + m[3], m[2]
        return np.stack([2 * ae + 4 * bd + 5 * c, 4 * ae + 9 * bd + 12 * c,
                         5 * ae + 12 * bd + 15 * c], -1)
    return ((m[0] + m[6]) + 6 * (m[1] + m[5]) + 15 * (m[2] + m[4]) + 20 * m[3])[..., None]


def gauss_column(win, ks):
    """``Gauss<KS>::column``: the blur from the row sums of the KS rows of
    its window, ``win`` (KS, ..., kHN) oldest first."""
    if ks == 3:
        acc = win[0][..., 0] + 2 * win[1][..., 0] + win[2][..., 0]
    elif ks == 5:
        acc = (win[0][..., 0] + win[4][..., 0]) + (win[1][..., 1] + win[3][..., 1]) + win[2][..., 2]
    else:
        acc = ((win[0][..., 0] + win[6][..., 0]) + 6 * (win[1][..., 0] + win[5][..., 0])
               + 15 * (win[2][..., 0] + win[4][..., 0]) + 20 * win[3][..., 0])
    return acc // KSUM[ks]


def blur_2d(mono, ks):
    """The 2-D taps and one floor division, on the (h, w) interior."""
    taps = np.asarray(GAUSSIAN_TAPS[ks], np.int64)
    h, w = mono.shape[0] - ks + 1, mono.shape[1] - ks + 1
    acc = np.zeros((h, w), np.int64)
    for dy in range(ks):
        for dx in range(ks):
            acc += taps[dy, dx] * mono[dy:dy + h, dx:dx + w]
    return acc // taps.sum()


def blur_walk(mono, ks):
    """The walk's form on the same interior: row sums, then the column."""
    h, w = mono.shape[0] - ks + 1, mono.shape[1] - ks + 1
    rows = gauss_row(np.stack([mono[:, i:i + w] for i in range(ks)], -1), ks)
    return gauss_column(np.stack([rows[i:i + h] for i in range(ks)]), ks)


def sobel_2d(b):
    sx = (-b[:-2, :-2] + b[:-2, 2:] - 2 * b[1:-1, :-2] + 2 * b[1:-1, 2:] - b[2:, :-2] + b[2:, 2:])
    sy = (b[:-2, :-2] + 2 * b[:-2, 1:-1] + b[:-2, 2:] - b[2:, :-2] - 2 * b[2:, 1:-1] - b[2:, 2:])
    return sx, sy


def sobel_walk(b):
    """D = b[x+1] - b[x-1], S = b[x-1] + 2 b[x] + b[x+1] a row; sx = D0 + 2
    D1 + D2, sy = S0 - S2 down the column."""
    d = b[:, 2:] - b[:, :-2]
    s = b[:, :-2] + 2 * b[:, 1:-1] + b[:, 2:]
    return d[:-2] + 2 * d[1:-1] + d[2:], s[:-2] - s[2:]


def nms_keep(sx, sy, gnw, gn, gne, gw, gc, ge, gsw, gs, gse):
    """``nms_keep`` of ``stage_chain.cuh``, elementwise."""
    v, wm = np.abs(sx) << 15, np.abs(sy)
    fu = np.where(sx >= 0, sy, -sy)
    vert, horz = v < wm * TG22, v >= wm * TG67
    q = np.where(vert, gs, np.where(horz, ge, np.where(fu > 0, gsw, gnw)))
    r = np.where(vert, gn, np.where(horz, gw, np.where(fu > 0, gne, gse)))
    return (q <= gc) & (r <= gc)


def class_bounds(lo, hi, coeff, l2, ref):
    def bound(t):
        if t >= 255:
            return 1 << 30
        s = ((t + 1) * 8 + coeff - 1) // coeff
        return s * s if l2 else s

    if ref:
        return bound(lo) - 1, bound(hi) - 1
    lo, hi = min(max(lo, 0), 2048), min(max(hi, 0), 2048)
    return (lo * lo, hi * hi) if l2 else (lo, hi)


# -- the model ----------------------------------------------------------------


def pieces_in_order(z, eh, ew, grid):
    """The persistent walk: block i takes pieces i, i + grid, ...; returns
    the pieces in the order the blocks reach them and checks each is taken
    exactly once."""
    n = z * -(-eh // PH) * -(-ew // PW)
    taken = [t for i in range(min(n, grid)) for t in range(i, n, grid)]
    assert sorted(taken) == list(range(n))
    return np.asarray(taken, np.int64)


def model_windows(frames, t: Tiling, route, *, kernel_size=5, base=0, grid=7):
    """The pieces of a launch in the order the blocks reach them, and each
    piece's staged window made mono: (SB, SH, SW[, 3]) uint8 frames ->
    a dict of the pieces' z, r0, c0, ey, ex (P,) and mono (P, MR, MW).
    ``base`` is the frames' address modulo a 512-byte allocation (the
    cp.async chunks' alignment)."""
    ks, k2 = kernel_size, kernel_size // 2
    r_h = k2 + 2
    mr, mw = PH + 2 * r_h, PW + 4 + 2 * k2
    sb, sh, sw = frames.shape[:3]
    c = 3 if frames.ndim == 4 else 1
    sp = (c * mw + 30) // 16 * 16
    pitch = c * sw
    ih, iw = t.image
    sy, sx = t.src_origin
    eh, ew = t.ext_h, t.ext_w
    nstrip, ncb = -(-eh // PH), -(-ew // PW)
    z_n = sb * t.ny * t.nx
    # The frames' bytes at their addresses; outside the buffer, garbage.
    pad = 64
    mem = np.full(base + sb * sh * pitch + 2 * pad, GARBAGE, np.uint8)
    mem[pad + base:pad + base + sb * sh * pitch] = frames.reshape(-1)

    tp = pieces_in_order(z_n, eh, ew, grid)
    per_z = nstrip * ncb
    z = tp // per_z
    rem = tp - z * per_z
    r0 = (rem // ncb) * PH
    c0 = (rem % ncb) * PW
    b = z // (t.ny * t.nx)
    ti, tj = (z // t.nx) % t.ny, z % t.nx
    ey = t.core_origin[0] + ti * t.h_loc - t.e_top
    ex = t.core_origin[1] + tj * t.w_loc - t.e_left
    ly0 = ey + r0 - r_h - sy
    lx0 = ex + c0 - 2 - k2 - sx
    npc = len(tp)

    # The staged window: mr rows of sp bytes a piece.
    ly = ly0[:, None] + np.arange(mr)[None, :]  # (P, mr)
    row_in_src = (ly >= 0) & (ly < sh)
    s_pos = np.arange(sp)
    row_addr = pad + base + (b[:, None] * sh + ly) * pitch  # (P, mr)
    if route == "tma":
        first = (c * lx0) & ~15  # the box's first byte of a row: 16-byte aligned
        col = first[:, None, None] + s_pos[None, None, :]
        ok = row_in_src[:, :, None] & (col >= 0) & (col < pitch)
        stage = np.where(ok, mem[np.where(ok, row_addr[:, :, None] + col, 0)], 0)
        off = np.broadcast_to(((c * lx0) & 15)[:, None], (npc, mr))
    else:
        start = row_addr + c * lx0[:, None]
        chunk0 = start & ~15
        addr = chunk0[:, :, None] + s_pos[None, None, :]
        ch = chunk0[:, :, None] + (s_pos // 16 * 16)[None, None, :]
        copied = (row_in_src[:, :, None] & (ch + 16 > row_addr[:, :, None])
                  & (ch < row_addr[:, :, None] + pitch))
        stage = np.where(copied, mem[np.clip(addr, 0, len(mem) - 1)], GARBAGE)
        off = start & 15
        assert (off[:, :, None] + c * mw <= sp).all()

    # Mono: zero outside the image and outside the source.
    j = np.arange(mw)
    gy = ly + sy
    gx = lx0[:, None] + j[None, :] + sx
    lx = lx0[:, None] + j[None, :]
    inside = ((row_in_src & (gy >= 0) & (gy < ih))[:, :, None]
              & ((gx >= 0) & (gx < iw) & (lx >= 0) & (lx < sw))[:, None, :])
    pos = off[:, :, None] + c * j[None, None, :]
    take = lambda k: np.take_along_axis(stage, pos + k, axis=2).astype(np.int64)  # noqa: E731
    mono = take(0) if c == 1 else (take(0) * 7 + take(1) * 38 + take(2) * 19) >> 6
    mono = np.where(inside, mono, 0)
    assert mono.max(initial=0) <= 255  # the kernel keeps mono in bytes
    return dict(z=z, r0=r0, c0=c0, ey=ey, ex=ex, mono=mono, z_n=z_n)


def model_ff_pack(frames, thr, t: Tiling, route, *, kernel_size=5, grad_coeff=4, norm="l2",
                  parity="reference", base=0, grid=7):
    """(SB, SH, SW[, 3]) uint8 frames -> (SB ny nx, ceil(EH/32), EW) int32
    planes, by the kernel's pieces. ``base`` is the frames' address modulo
    a 512-byte allocation (the cp.async chunks' alignment)."""
    ks = kernel_size
    pcs = model_windows(frames, t, route, kernel_size=ks, base=base, grid=grid)
    z, r0, c0, ey, ex, mono, z_n = (pcs[k] for k in ("z", "r0", "c0", "ey", "ex", "mono", "z_n"))
    npc = len(z)
    ih, iw = t.image
    eh, ew = t.ext_h, t.ext_w

    # The walk, every lane of every piece at once.
    warp, lane = np.divmod(np.arange(NL), 32)
    xe = c0[:, None] - 2 + warp[None, :] * LANES_OUT + lane[None, :]  # (P, NL)
    gxe = ex[:, None] + xe
    col_in = (gxe >= 0) & (gxe < iw)
    out_lane = (lane >= 2)[None, :] & (lane < 30)[None, :] & (xe < ew)
    rr, rc = t.ring
    col_ok = out_lane & (xe >= rc) & (xe < ew - rc)
    l2, ref = norm == "l2", parity == "reference"
    lo_c, hi_c = class_bounds(int(thr[0]), int(thr[1]), grad_coeff, l2, ref)
    j0 = warp * LANES_OUT + lane
    taps_idx = j0[:, None] + np.arange(ks)[None, :]

    def shfl(v, delta):  # __shfl_up (delta 1) / __shfl_down (-1) within each warp
        w3 = v.reshape(npc, NWARP, 32)
        out = w3.copy()
        if delta == 1:
            out[..., 1:] = w3[..., :-1]
        else:
            out[..., :-1] = w3[..., 1:]
        return out.reshape(npc, NL)

    nwr = -(-eh // 32)
    fpl = np.zeros((z_n, nwr, ew), np.int64)
    ppl = np.zeros_like(fpl)
    written = np.zeros((z_n, nwr, ew), np.int64)
    zi = np.broadcast_to(z[:, None], (npc, NL))
    zeros = np.zeros((npc, NL), np.int64)
    for rg in range(NRG):  # each row group walks one word row of the piece
        ybase = 32 * rg
        # The classes count in rows inside the extended tile, off the ring,
        # in the image, and in the columns likewise.
        ye = r0[:, None] + ybase + np.arange(32)[None, :]  # (P, 32)
        row_ok = (ye < eh) & (ye >= rr) & (ye < eh - rr) & (ey[:, None] + ye >= 0) & (
            ey[:, None] + ye < ih)
        # The window: mono rows from 32 rg; the first KS - 1 row sums.
        hwin = [gauss_row(mono[:, ybase + q][:, taps_idx], ks) for q in range(ks - 1)]
        d_w, s_w = [zeros] * 2, [zeros] * 2
        g_w = {k: [zeros] * 2 for k in "lcr"}
        sxp = syp = zeros
        fw, pw = zeros.copy(), zeros.copy()
        for i in range(36):
            yb = ybase - 2 + i
            hwin = (hwin + [gauss_row(mono[:, ybase + i + ks - 1][:, taps_idx], ks)])[-ks:]
            gyb = ey + r0 + yb
            blur = np.where(col_in & ((gyb >= 0) & (gyb < ih))[:, None], gauss_column(hwin, ks), 0)
            bl, br = shfl(blur, 1), shfl(blur, -1)
            d2, s2 = br - bl, bl + 2 * blur + br
            if i >= 2:
                sxv, syv = d_w[0] + 2 * d_w[1] + d2, s_w[0] - s2
                gys = gyb - 1
                mag = sxv * sxv + syv * syv if l2 else np.abs(sxv) + np.abs(syv)
                gm = np.where(col_in & ((gys >= 0) & (gys < ih))[:, None], mag, 0)
                gl, gr = shfl(gm, 1), shfl(gm, -1)
                if i >= 4:
                    bit = i - 4
                    ok = col_ok & col_in & row_ok[:, bit][:, None]
                    keep = ok & nms_keep(sxp, syp, g_w["l"][0], g_w["c"][0], g_w["r"][0],
                                         g_w["l"][1], g_w["c"][1], g_w["r"][1], gl, gm, gr)
                    gc = g_w["c"][1]
                    fw |= (keep & (gc > hi_c)).astype(np.int64) << bit
                    pw |= (keep & (gc <= hi_c) & (gc > lo_c)).astype(np.int64) << bit
                g_w = {"l": [g_w["l"][1], gl], "c": [g_w["c"][1], gm], "r": [g_w["r"][1], gr]}
                sxp, syp = sxv, syv
            d_w, s_w = [d_w[1], d2], [s_w[1], s2]
        k = np.broadcast_to(((r0 + ybase) >> 5)[:, None], (npc, NL))
        st = out_lane & (k < nwr)
        fpl[zi[st], k[st], xe[st]] = fw[st]
        ppl[zi[st], k[st], xe[st]] = pw[st]
        np.add.at(written, (zi[st], k[st], xe[st]), 1)
    assert (written == 1).all(), "a word was not written exactly once"
    to32 = lambda a: torch.from_numpy(((a + 2**31) % 2**32 - 2**31).astype(np.int32))  # noqa: E731
    return to32(fpl), to32(ppl)


def _route(frames: np.ndarray, base: int) -> str:
    """The kernel's rule (``cc_ff_pack_route``)."""
    c = 3 if frames.ndim == 4 else 1
    return "tma" if base % 16 == 0 and (c * frames.shape[2]) % 16 == 0 else "cp.async"


def _frames(h, w, n=1, seed=0):
    if min(h, w) < 8:
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    fr = [make_scene(h, w, seed=seed + s) for s in range(n - 1)] + [make_spiral_frame(h, w)]
    return np.stack(fr)


CONFIGS = [{}, dict(kernel_size=3, norm="l1"), dict(kernel_size=7, parity="opencv", grad_coeff=2)]
WHOLE = [(1, 1), (2, 5), (37, 53), (33, 1919), (80, 256)]


def _check(frames, thr, tiling, route, kw, base=0, grid=7):
    f, p = model_ff_pack(frames, thr, tiling, route, base=base, grid=grid, **kw)
    tf = torch.from_numpy(frames)
    want = [ff_pack_plain(fr, thr, tiling=tiling, **kw) for fr in tf]
    assert torch.equal(f, torch.cat([a for a, _ in want]))
    assert torch.equal(p, torch.cat([b for _, b in want]))


@pytest.mark.parametrize("h,w", WHOLE)
@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("route", ["auto", "cp.async"])
def test_whole_frames_match_plain(h, w, kw, route):
    frames = _frames(h, w, n=1, seed=h + w)
    thr = torch.tensor([10, 40], dtype=torch.int32)
    for x in (frames, np.ascontiguousarray(frames[..., 2])):
        base = 0 if route == "auto" else 5
        r = _route(x, base) if route == "auto" else route
        _check(x, thr, Tiling.whole(h, w), r, kw, base=base)


@pytest.mark.parametrize("lo,hi", [(0, 0), (254, 255), (-3, 300)])
def test_thresholds_match_plain(lo, hi):
    frames = _frames(37, 53, n=1, seed=3)
    _check(frames, torch.tensor([lo, hi], dtype=torch.int32), Tiling.whole(37, 53), "tma", {})


#: tests/test_torch_cuda.py::SHARDED, and tilings whose tile pitch is not
#: 16-byte aligned: 959 BGR columns on a 1918-pixel frame (neither aligned),
#: 968 on a 1936-pixel frame (an aligned frame, unaligned tile origins).
SHARDED = [((96, 384), (1, 2, 1)), ((200, 320), (1, 2, 2)), ((64, 96), (2, 4, 2)),
           ((37, 53), (1, 1, 1)), ((540, 960), (1, 2, 2)), ((66, 1918), (1, 2, 2)),
           ((64, 1936), (1, 1, 2))]


@pytest.mark.parametrize("hw,mesh", SHARDED)
@pytest.mark.parametrize("kw", CONFIGS)
def test_export_tilings_match_plain(hw, mesh, kw):
    h, w = hw
    t = build_sharded_pipeline(CannyConfig(height=h, width=w, **kw), make_mesh(*mesh)).tiling
    frames = _frames(h, w, n=2)
    thr = torch.tensor([10, 40], dtype=torch.int32)
    for x, base in ((frames, 0), (np.ascontiguousarray(frames[..., 1]), 0), (frames, 7)):
        _check(x, thr, t, _route(x, base), kw, base=base, grid=5)


def test_shifted_source_and_image():
    """A source window at a global origin inside a larger image (pixels of
    the source outside the image and of the image outside the source read
    zero), with a ring as deep as the stencils reach (R = 4 rows at kernel
    size 5: inside it the plain version's window ends and the kernel's reads
    on), more tiles than fit the grid, rows past EH."""
    frames = _frames(70, 90, n=2, seed=11)
    t = Tiling(2, 3, 30, 28, 5, 6, 41, 40, (64, 80), core_origin=(3, -2), src_origin=(-4, 5),
               ring=(4, 5))
    thr = torch.tensor([10, 40], dtype=torch.int32)
    for x, base in ((frames, 0), (np.ascontiguousarray(frames[..., 0]), 3)):
        _check(x, thr, t, "cp.async", {}, base=base, grid=3)
        _check(x, thr, t, "tma", {}, base=0, grid=4)


def test_persistent_order_covers_every_piece_once():
    for z, eh, ew, grid in ((1, 1080, 1920, 660), (8, 1144, 1984, 660), (3, 1, 1, 7),
                            (2, 65, 113, 1)):
        order = pieces_in_order(z, eh, ew, grid)
        assert len(order) == z * -(-eh // PH) * -(-ew // PW)


@pytest.mark.parametrize("ks", [3, 5, 7])
@pytest.mark.parametrize("kind", ["random", "zeros", "full"])
def test_gaussian_and_sobel_forms_are_exact(ks, kind):
    assert GAUSSIAN_TAPS == JAX_TAPS  # the port's taps are the reference's
    rng = np.random.default_rng(ks)
    shape = (40 + ks, 50 + ks)
    mono = {"random": rng.integers(0, 256, shape), "zeros": np.zeros(shape, np.int64),
            "full": np.full(shape, 255, np.int64)}[kind].astype(np.int64)
    assert mono.min() >= 0 and mono.max() <= 255
    rows = gauss_row(np.stack([mono[:, i:i + 4] for i in range(ks)], -1), ks)
    assert rows.max() * KSUM[ks] < 2**31  # the row sums and the column stay in int32
    b2, bw = blur_2d(mono, ks), blur_walk(mono, ks)
    np.testing.assert_array_equal(b2, bw)
    assert 0 <= bw.min() and bw.max() <= 255  # blur fits a byte
    if kind == "full":
        assert (bw == 255).all()
    sx2, sy2 = sobel_2d(bw)
    sxw, syw = sobel_walk(bw)
    np.testing.assert_array_equal(sx2, sxw)
    np.testing.assert_array_equal(sy2, syw)
    edge = rng.integers(0, 256, (20, 20)) * rng.integers(0, 2, (20, 20))  # saturated edges
    for b in (bw, edge.astype(np.int64)):
        sx, sy = sobel_walk(b)
        assert np.abs(sx).max(initial=0) <= 1020 and np.abs(sy).max(initial=0) <= 1020
        assert (sx.astype(np.int16) == sx).all() and (sy.astype(np.int16) == sy).all()
    assert 2 * 1020 * 1020 < 2**31 and (1020 << 15) < 2**31 and 1020 * TG67 < 2**31
