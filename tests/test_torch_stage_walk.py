"""The stage walk of the ``ff_stages`` kernel (``csrc/ff_stages.cu`` on the
pieces of ``csrc/ff_walk.cuh``) and the column walk of ``pack_thresh``
(``csrc/pack.cu`` on ``csrc/pack_walk.cuh``) as NumPy models, against the
port's plain versions and the JAX package's kernels in interpret mode.

``ff_stages`` runs ``ff_pack``'s launch with one tile a frame (no
extension, no ring; with an origin, the tile's pixel (0, 0) at a global
position of a larger image): the same pieces in the same persistent order,
the same staged windows made mono (``test_torch_ff_pack_tiles.model_windows``
models both load routes), the same column walk. Where ``ff_pack``'s sink
packs the classes, this sink stores, for the walk's rows b = 0..31 of a
word row, at the step that makes each value: MONO (read from the mono
plane) and GAUSSIAN at step b + 2 with the blur row, GRADIENT at b + 3 with
the Sobel sums, NMS and THRESH at b + 4 with the NMS decision (the display
magnitude carried from the Sobel step before), each a byte a lane, lanes
2..29: a warp stores a run of 28 neighbouring columns of a row. NMSQ (alone)
goes to the piece's tile at b + 4 instead, and after the walk each tile row
goes out as the 16-byte aligned blocks of its address range: whole blocks
(4 values) as one vector store, the row's first block (head) and last
(tail) value by value where they hold values of the neighbouring pieces.
The walk stops at the deepest stage asked for: MONO alone copies the mono
plane with no walk, MONO / GAUSSIAN / GRADIENT stop at the Sobel sums (no
magnitude, no NMS).

``pack_thresh``: thread (k, c) holds the 32 values of column c in word row
k (0 past H), a u8 map's 255 / 128 / other as 2 / 1 / 0 against [0, 1], a
keep*g plane's values clamped at 0 against [lo, hi] clamped at 0, and
appends the sign of bound - value to each word, row 31 first.

Tolerance: 0. Every value is an integer stage value or a packed word.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.ops.pallas import feedforward as jff
from cudacam_tpu_torch.io.sources import make_scene
from cudacam_tpu_torch.ops.cuda.feedforward import (
    FF_STAGES, NMSQ, Tiling, ff_stages_batched, ff_stages_plain,
)
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import pack_thresh_plain
from tests.test_torch_ff_pack_tiles import (
    LANES_OUT, NL, NRG, NWARP, class_bounds, gauss_column, gauss_row, model_windows, nms_keep,
)

torch.set_num_threads(2)

MONO, GAUSS, GRAD, NMS, THRESH = FF_STAGES
K_MONO, K_BLUR, K_MAG = 1, 2, 3  # stage_chain.cuh's Depth
M32 = 0xFFFFFFFF


def depth_of(stages) -> int:
    """``cc_ff_stages``' rule: the deepest stage an output needs."""
    if {NMS, THRESH, NMSQ} & set(stages):
        return K_MAG
    return K_BLUR if {GAUSS, GRAD} & set(stages) else K_MONO


def display_magnitude(sx, sy, coeff, l2):
    """``display_magnitude``: a float32 sqrt and the two integer fix-ups."""
    if l2:
        m = sx * sx + sy * sy
        s = np.sqrt(m.astype(np.float32)).astype(np.int64)
        s = s - (s * s > m)
        s = s + ((s + 1) * (s + 1) <= m)
        val = (s * coeff) >> 3
    else:
        val = (coeff * (np.abs(sx) + np.abs(sy))) >> 3
    return np.minimum(val, 255)


def model_ff_stages(frames, thr, stages, route, *, origin=None, image=None, kernel_size=5,
                    grad_coeff=4, norm="l2", parity="reference", base=0, grid=7, nmsq_base=0):
    """(B, H, W[, 3]) uint8 frames -> ({stage: (B, H, W) buffer}, trace),
    by the kernel's pieces and walk. ``nmsq_base`` is the NMSQ plane's
    address modulo 16, in values (0..3). The trace holds, per output, the
    walk step at which each row bit of a word row was stored (-1: the mono
    copy, no walk), the stores per pixel, each row's runs of columns (a
    warp's u8 store; NMSQ's copy-out blocks, with their kind) and the steps
    the walk ran and of those the ones that ran the NMS."""
    stages = tuple(stages)
    nb, h, w = frames.shape[:3]
    oy, ox = origin if origin is not None else (0, 0)
    ih, iw = image if image is not None else (h, w)
    # One tile a frame, at the origin, no extension, no ring.
    t = Tiling(1, 1, h, w, 0, 0, h, w, (ih, iw), core_origin=(oy, ox), src_origin=(oy, ox))
    ks, k2 = kernel_size, kernel_size // 2
    r_h = k2 + 2
    depth = depth_of(stages)
    top = 2 if depth == K_MAG else 1
    pcs = model_windows(frames, t, route, kernel_size=ks, base=base, grid=grid)
    z, r0, c0, ey, ex, mono = (pcs[k] for k in ("z", "r0", "c0", "ey", "ex", "mono"))
    npc = len(z)
    l2, ref = norm == "l2", parity == "reference"
    coeff = grad_coeff if ref else 8
    lo_c, hi_c = class_bounds(int(thr[0]), int(thr[1]), grad_coeff, l2, ref) if thr is not None \
        else (0, 0)

    sentinel = -(2**40)
    outs = {s: np.full((nb, h, w), sentinel, np.int64) for s in stages}
    writes = {s: np.zeros((nb, h, w), np.int64) for s in stages}
    step_of = {s: {} for s in stages}  # bit -> steps it was stored at
    runs = {}  # (z, row) -> [(first column, length)] a warp's store, or [(kind, first, length)]
    trace = dict(step_of=step_of, writes=writes, runs=runs, steps=0, nms_steps=0)

    warp, lane = np.divmod(np.arange(NL), 32)
    xe = c0[:, None] - 2 + warp[None, :] * LANES_OUT + lane[None, :]  # (P, NL)
    gxe = ex[:, None] + xe
    col_in = (gxe >= 0) & (gxe < iw)
    out_lane = (lane >= 2)[None, :] & (lane < 30)[None, :] & (xe < w)
    j0 = warp * LANES_OUT + lane
    taps_idx = j0[:, None] + np.arange(ks)[None, :]
    zi = np.broadcast_to(z[:, None], (npc, NL))
    zeros = np.zeros((npc, NL), np.int64)

    def shfl(v, delta):
        w3 = v.reshape(npc, NWARP, 32)
        out = w3.copy()
        if delta == 1:
            out[..., 1:] = w3[..., :-1]
        else:
            out[..., :-1] = w3[..., 1:]
        return out.reshape(npc, NL)

    tile = np.full((npc, 32 * NRG, NWARP * LANES_OUT), sentinel, np.int64)  # NMSQ's tiles
    for rg in range(NRG):
        ybase = 32 * rg
        y0 = r0 + ybase
        ye = y0[:, None] + np.arange(32)[None, :]  # (P, 32)
        row_ok = (ye < h) & (ey[:, None] + ye >= 0) & (ey[:, None] + ye < ih)  # class counts
        mono_c = mono[:, ybase + r_h:ybase + r_h + 32][:, :, j0 + k2]  # (P, 32 rows, NL)

        def store(stage, bit, val, step):
            if stage not in outs or not 0 <= bit < 32:
                return
            if stage == NMSQ:  # to the piece's tile: every lane that emits a column
                em = np.broadcast_to(((lane >= 2) & (lane < 30))[None, :], (npc, NL))
                jj = np.broadcast_to(xe - c0[:, None], (npc, NL))
                pi = np.broadcast_to(np.arange(npc)[:, None], (npc, NL))
                tile[pi[em], ybase + bit, jj[em]] = np.broadcast_to(val, (npc, NL))[em]
                step_of[stage].setdefault(bit, set()).add(step)
                return
            ok = out_lane & (ye[:, bit] < h)[:, None]
            yy = np.broadcast_to(ye[:, bit][:, None], (npc, NL))
            outs[stage][zi[ok], yy[ok], xe[ok]] = np.broadcast_to(val, (npc, NL))[ok]
            np.add.at(writes[stage], (zi[ok], yy[ok], xe[ok]), 1)
            step_of[stage].setdefault(bit, set()).add(step)
            if stage == stages[0]:
                for p in range(npc):
                    for wp in range(NWARP):
                        cols = xe[p, wp * 32:(wp + 1) * 32][ok[p, wp * 32:(wp + 1) * 32]]
                        if len(cols):
                            assert (np.diff(cols) == 1).all()  # neighbouring columns
                            runs.setdefault((z[p], ye[p, bit]), []).append((cols[0], len(cols)))

        if depth == K_MONO:
            for bit in range(32):
                store(MONO, bit, mono_c[:, bit], -1)
            continue
        gyb0 = ey + y0 - 2
        valid = col_in[:, :, None] & ((gyb0[:, None] + np.arange(36)[None, :] >= 0)
                                      & (gyb0[:, None] + np.arange(36)[None, :] < ih))[:, None, :]
        hwin = [gauss_row(mono[:, ybase + q][:, taps_idx], ks) for q in range(ks - 1)]
        d_w, s_w = [zeros] * 2, [zeros] * 2
        g_w = {k: [zeros] * 2 for k in "lcr"}
        sxp = syp = zeros
        disp = zeros
        for i in range(34 + top):
            stage_i = min(top, 0 if i < 2 else (1 if i < 4 else 2))
            trace["steps"] = max(trace["steps"], i + 1)
            hwin = (hwin + [gauss_row(mono[:, ybase + i + ks - 1][:, taps_idx], ks)])[-ks:]
            blur = np.where(valid[:, :, i], gauss_column(hwin, ks), 0)
            if 0 <= i - 2 < 32:
                store(MONO, i - 2, mono_c[:, i - 2], i)
                store(GAUSS, i - 2, blur, i)
            bl, br = shfl(blur, 1), shfl(blur, -1)
            d2, s2 = br - bl, bl + 2 * blur + br
            if stage_i >= 1:
                sxv, syv = d_w[0] + 2 * d_w[1] + d2, s_w[0] - s2
                inside = valid[:, :, i - 1]
                if depth == K_MAG:
                    mag = sxv * sxv + syv * syv if l2 else np.abs(sxv) + np.abs(syv)
                    gm = np.where(inside, mag, 0)
                    gl, gr = shfl(gm, 1), shfl(gm, -1)
                    if stage_i == 2:
                        bit = i - 4
                        trace["nms_steps"] += 1
                        keep = (row_ok[:, bit][:, None] & out_lane & col_in
                                & nms_keep(sxp, syp, g_w["l"][0], g_w["c"][0], g_w["r"][0],
                                           g_w["l"][1], g_w["c"][1], g_w["r"][1], gl, gm, gr))
                        gc = g_w["c"][1]
                        store(NMS, bit, np.where(keep, disp, 0), i)
                        store(THRESH, bit, np.where(keep, np.where(gc > hi_c, 255, np.where(
                            gc > lo_c, 128, 0)), 0), i)
                        store(NMSQ, bit, np.where(keep, gc, 0), i)
                    g_w = {"l": [g_w["l"][1], gl], "c": [g_w["c"][1], gm],
                           "r": [g_w["r"][1], gr]}
                disp = np.where(inside, display_magnitude(sxv, syv, coeff, l2), 0)
                store(GRAD, i - 3, disp, i)
                sxp, syp = sxv, syv
            d_w, s_w = [d_w[1], d2], [s_w[1], s2]
    if NMSQ in stages:
        model_copy_rows(tile, outs[NMSQ], writes[NMSQ], runs, z, r0, c0, h, w, nmsq_base)
    for s in stages:
        assert (writes[s] == 1).all(), f"{s}: an output pixel was not stored exactly once"
    return {s: torch.from_numpy(outs[s].astype(np.int32 if s == NMSQ else np.uint8))
            for s in stages}, trace


def model_copy_rows(tile, out, writes, runs, z, r0, c0, h, w, base):
    """``copy_rows``: each piece's NMSQ tile rows to the (B, H, W) plane,
    whose value 0 lies at ``base`` (values past a 16-byte boundary). A row's
    blocks are the 16-byte aligned blocks of its address range: a whole one
    (4 values) is one vector store ("body"), the first and last ("head",
    "tail") go value by value."""
    pw = tile.shape[2]
    for p in range(len(z)):
        nr, n = min(tile.shape[1], h - r0[p]), min(pw, w - c0[p])
        for r in range(nr):
            e = (z[p] * h + r0[p] + r) * w + c0[p]  # the row's first value
            sh = (base + e) % 4  # values past the 16-byte boundary
            for k in range(pw // 4 + 1):
                s0 = 4 * k - sh
                if s0 >= n or s0 + 4 <= 0:
                    continue
                a, b = max(s0, 0), min(s0 + 4, n)
                kind = "body" if (s0 >= 0 and s0 + 4 <= n) else ("head" if s0 < 0 else "tail")
                if kind == "body":
                    assert (base + e + s0) % 4 == 0  # the vector store's address is 16-byte aligned
                yy, xx = r0[p] + r, c0[p] + np.arange(a, b)
                out[z[p], yy, xx] = tile[p, r, a:b]
                writes[z[p], yy, xx] += 1
                runs.setdefault((z[p], yy), []).append((kind, c0[p] + a, b - a))


def _route(frames: np.ndarray, base: int) -> str:
    c = 3 if frames.ndim == 4 else 1
    return "tma" if base % 16 == 0 and (c * frames.shape[2]) % 16 == 0 else "cp.async"


def _frames(h, w, n=1, seed=0):
    if min(h, w) < 8:
        return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    return np.stack([make_scene(h, w, seed=seed + s) for s in range(n)])


CONFIGS = [{}, dict(kernel_size=3, norm="l1"), dict(kernel_size=7, parity="opencv", grad_coeff=2),
           dict(kernel_size=5, norm="l1", parity="opencv")]
SETS = [FF_STAGES, (NMSQ,), (GRAD,), (MONO,), (GAUSS, MONO), (THRESH,), (NMS, GRAD)]
THR = torch.tensor([10, 40], dtype=torch.int32)


def _check(frames, thr, stages, route, kw, base=0, grid=7, origin=None, image=None):
    got, trace = model_ff_stages(frames, thr, stages, route, origin=origin, image=image,
                                 base=base, grid=grid, **kw)
    for b, fr in enumerate(torch.from_numpy(frames)):
        want = ff_stages_plain(fr, thr, stages, origin=origin, image_size=image, **kw)
        for s, e in zip(stages, want):
            assert torch.equal(got[s][b], e), (s, b, kw, origin)
    return got, trace


@pytest.mark.parametrize("h,w", [(1, 1), (2, 5), (37, 53), (33, 70), (70, 130)])
@pytest.mark.parametrize("kw", CONFIGS)
def test_whole_frames_match_plain(h, w, kw):
    """Every stage set, BGR and gray, both load routes; each output pixel
    stored exactly once (the model asserts it)."""
    frames = _frames(h, w, seed=h * w)
    for x in (frames, np.ascontiguousarray(frames[..., 0])):
        for stages in SETS:
            for base in (0, 5):
                _check(x, THR, stages, _route(x, base), kw, base=base)


@pytest.mark.parametrize("lo,hi", [(-3, 300), (0, 0), (254, 255)])
@pytest.mark.parametrize("kw", [{}, dict(norm="l1")])
def test_thresholds_keep_gated(lo, hi, kw):
    """Classes are keep-gated: with a low threshold whose bound is negative
    (-3, L1) every kept pixel is at least CANDIDATE, and the pixels NMS
    drops stay 0."""
    frames = _frames(37, 53, seed=9)
    thr = torch.tensor([lo, hi], dtype=torch.int32)
    got, _ = _check(frames, thr, FF_STAGES, "cp.async", kw, base=3)
    t, n = got[THRESH][0], got[NMS][0]
    assert ((t == 0) | (t == 128) | (t == 255)).all()
    if lo < 0 and kw:
        assert (t[n > 0] > 0).all() and (t == 0).any() and (t == 128).sum() > (n > 0).sum() // 2


@pytest.mark.parametrize("h,w,n", [(37, 53, 3), (64, 120, 2), (70, 57, 4)])
def test_batches_match_single_frames(h, w, n):
    """One launch for B frames: pieces walk (piece, then frame); each frame's
    buffers equal its solo model and the plain version."""
    frames = _frames(h, w, n=n, seed=n)
    for stages in (FF_STAGES, (NMSQ,)):
        got, _ = _check(frames, THR, stages, _route(frames, 0), {}, grid=5)
        for b in range(n):
            solo, _ = model_ff_stages(frames[b:b + 1], THR, stages, _route(frames, 0))
            for s in stages:
                assert torch.equal(got[s][b], solo[s][0])
        batched = ff_stages_batched(torch.from_numpy(frames), THR, stages)
        for s, e in zip(stages, batched):
            assert torch.equal(got[s], e)


#: (frame shape, origin, image): the halo-extended tiles of the sharded
#: display route, their pixel (0, 0) at a global origin.
ORIGINS = [((48, 72), (-4, -4), (88, 136)), ((48, 72), (40, 64), (88, 136)),
           ((37, 53), (-3, 20), (30, 80)), ((70, 60), (10, -7), (64, 50))]


@pytest.mark.parametrize("shape,origin,image", ORIGINS)
@pytest.mark.parametrize("kw", CONFIGS[:3])
def test_origin_tiles_match_plain(shape, origin, image, kw):
    frames = _frames(*shape, seed=sum(shape))
    for x in (frames, np.ascontiguousarray(frames[..., 2])):
        for stages in (FF_STAGES, (NMSQ,), (GRAD,), (MONO,)):
            _check(x, THR, stages, _route(x, 0), kw, origin=origin, image=image)


def test_output_rows_per_step():
    """Row b of a word row: MONO and GAUSSIAN at step b + 2 (the blur row),
    GRADIENT at b + 3 (the Sobel sums), NMS, THRESH and NMSQ at b + 4 (the
    NMS decision); 36 steps."""
    frames = _frames(70, 60, seed=1)
    for stages in (FF_STAGES, (NMSQ,)):
        _, trace = _check(frames, THR, stages, "tma", {})
        assert trace["steps"] == 36 and trace["nms_steps"] == 32 * NRG
        lag = {MONO: 2, GAUSS: 2, GRAD: 3, NMS: 4, THRESH: 4, NMSQ: 4}
        for s in stages:
            assert trace["step_of"][s] == {b: {b + lag[s]} for b in range(32)}, s


def test_gradient_only_depth_stops_at_the_sobel_sums():
    """GRADIENT alone (or with MONO / GAUSSIAN): no magnitude, no NMS; 35
    steps, row 31's Sobel sums last. MONO alone: the mono plane copied, no
    walk."""
    frames = _frames(70, 60, seed=2)
    for stages in ((GRAD,), (GAUSS, GRAD, MONO)):
        assert depth_of(stages) == K_BLUR
        _, trace = _check(frames, THR, stages, "tma", {})
        assert trace["steps"] == 35 and trace["nms_steps"] == 0
        assert trace["step_of"][GRAD] == {b: {b + 3} for b in range(32)}
    _, trace = _check(frames, None, (MONO,), "cp.async", {}, base=7)
    assert trace["steps"] == 0 and trace["step_of"][MONO] == {b: {-1} for b in range(32)}


@pytest.mark.parametrize("w", [1, 5, 27, 28, 29, 53, 56, 57, 70, 113, 481])
def test_row_stores_cover_each_row_once(w):
    """Each warp stores a run of up to 28 neighbouring columns of a row
    (lanes 2..29); the runs of a row tile [0, W) with no overlap and no
    gap, at odd widths."""
    frames = _frames(3, w, seed=w)
    _, trace = _check(frames, THR, (MONO, NMS), _route(frames, 0), {})
    rows = {}
    for (zz, y), rr in trace["runs"].items():
        rows.setdefault((zz, y), []).extend(rr)
    assert len(rows) == 3
    for rr in rows.values():
        rr.sort()
        assert rr[0][0] == 0 and all(n <= LANES_OUT for _, n in rr)
        assert all(a + n == b for (a, n), (b, _) in zip(rr, rr[1:]))
        assert rr[-1][0] + rr[-1][1] == w


def test_display_root_fixups_are_exact():
    """``display_magnitude`` takes the root from an approximate reciprocal
    square root: every m the Sobel sums can give (|sx|, |sy| <= 1020, m <
    2^21) is exactly representable as a float, and from any estimate within
    1 of floor(sqrt(m)) the two integer fix-ups reach floor(sqrt(m))."""
    m_max = 2 * 1020 * 1020
    assert m_max < 2**21
    m = np.arange(m_max + 1, dtype=np.int64)
    assert (m.astype(np.float32).astype(np.int64) == m).all()
    root = np.floor(np.sqrt(m)).astype(np.int64)
    assert (root * root <= m).all() and ((root + 1) ** 2 > m).all()
    for est in (root - 1, root, root + 1):
        s = np.maximum(est, 0)
        s = s - (s * s > m)
        s = s + ((s + 1) * (s + 1) <= m)
        np.testing.assert_array_equal(s, root)


@pytest.mark.parametrize("w", [1, 3, 5, 53, 56, 57, 70, 113, 481])
@pytest.mark.parametrize("nmsq_base", [0, 1, 3])
def test_nmsq_copy_blocks_cover_each_row_once(w, nmsq_base):
    """NMSQ's tile rows go out as 16-byte aligned vector stores (bodies)
    with a head and a tail of single values where a piece's row does not
    start or end on a 16-byte boundary; over all pieces every value of a
    row is stored once, at odd widths and at each alignment of the plane
    (the model asserts both)."""
    frames = _frames(5, w, n=2, seed=w)
    got, trace = _check(frames, None, (NMSQ,), _route(frames, 0), {})
    alt, _ = model_ff_stages(frames, None, (NMSQ,), _route(frames, 0), nmsq_base=nmsq_base)
    assert torch.equal(alt[NMSQ], got[NMSQ])
    blocks = [b for rr in trace["runs"].values() for b in rr]
    assert all((kind == "body") == (n == 4) for kind, _, n in blocks)
    if w >= 57:  # two pieces a row at least, rows starting at every alignment
        assert {kind for kind, _, _ in blocks} == {"head", "body", "tail"}


# -- through to the JAX package's kernel ---------------------------------------


def _jax_all(x, kw, **geo):
    return jff.feed_forward_all_stages(jnp.asarray(x), jnp.int32(10), jnp.int32(40),
                                       interpret=True, **kw, **geo)


@pytest.mark.parametrize("kw", CONFIGS[:3])
def test_model_matches_jax_all_stages(kw):
    """The model against ``feed_forward_all_stages`` (planar BGR, five
    outputs) and ``feed_forward_nmsq`` (mono) in interpret mode."""
    fr = make_scene(32, 128, seed=1)
    got, _ = model_ff_stages(fr[None], THR, FF_STAGES, "tma", **kw)
    want = _jax_all(np.transpose(fr, (2, 0, 1)), kw, block_h=16)
    for s, e in zip(FF_STAGES, want):
        np.testing.assert_array_equal(got[s][0].numpy(), np.asarray(e), err_msg=str(s))
    mono = got[MONO][0].numpy()
    nkw = {k: v for k, v in kw.items() if k != "parity" and k != "grad_coeff"}
    (kg,) = model_ff_stages(mono[None], None, (NMSQ,), "cp.async", base=3, **nkw)[0].values()
    want = jff.feed_forward_nmsq(jnp.asarray(mono), interpret=True, **nkw)
    np.testing.assert_array_equal(kg[0].numpy(), np.asarray(want))


def test_model_matches_jax_origin_tile():
    """Halo-extended tiles at a global origin, zero outside the image as the
    sharded route builds them: the model against the JAX kernel's origin /
    image_size, its edges inside the image included (the blur and the
    magnitudes beyond the tile come from zero mono there, on both sides).
    Outside the image the port's GRADIENT is 0 (``ff_stages``' contract),
    where the JAX kernel shows the magnitude of its unmasked Sobel sums; no
    core of a sharded frame lies there, so GRADIENT is compared inside the
    image and every other output everywhere."""
    fr = make_scene(48, 72, seed=3)[..., 1].copy()
    for origin, image in (((-4, -4), (88, 136)), ((40, 64), (88, 136)), ((-3, 20), (30, 80))):
        x = _window_in_image(fr, origin, image)
        inside = _window_in_image(np.ones_like(fr), origin, image) == 1
        got, _ = model_ff_stages(x[None], THR, FF_STAGES[1:], "tma", origin=origin, image=image)
        want = _jax_all(x, {}, origin=origin, image_size=image)
        for s, e in zip(FF_STAGES[1:], want):
            e = np.asarray(e)
            if s == GRAD:
                assert (got[s][0].numpy()[~inside] == 0).all()
                e = np.where(inside, e, 0)
            np.testing.assert_array_equal(got[s][0].numpy(), e, err_msg=str(s))
        (kg,) = model_ff_stages(x[None], None, (NMSQ,), "cp.async", base=9, origin=origin,
                                image=image)[0].values()
        want = jff.feed_forward_nmsq(jnp.asarray(x), interpret=True, origin=origin,
                                     image_size=image)
        np.testing.assert_array_equal(kg[0].numpy(), np.asarray(want))


def _window_in_image(frame, origin, image):
    """``frame`` with its pixels outside the image set to 0."""
    rows = np.arange(frame.shape[0]) + origin[0]
    cols = np.arange(frame.shape[1]) + origin[1]
    inside = (((rows >= 0) & (rows < image[0]))[:, None]
              & ((cols >= 0) & (cols < image[1]))[None, :])
    return np.where(inside, frame, 0).astype(np.uint8)


# -- pack_thresh's column walk ---------------------------------------------------


def model_pack_thresh(src: np.ndarray, bounds=None):
    """(H, W) u8 map or int32 keep*g (with bounds) -> (ceil(H/32), W) int32
    FINAL and CANDIDATE planes, thread by thread (every thread at once)."""
    h, w = src.shape
    hw = -(-h // 32)
    if bounds is None:  # the u8 mode's classes against [0, 1]
        val = np.where(src == 255, 2, np.where(src == 128, 1, 0)).astype(np.int64)
        lo, hi = 0, 1
    else:
        val = np.maximum(src.astype(np.int64), 0)
        lo, hi = (max(int(b), 0) for b in bounds)
    v = np.zeros((hw * 32, w), np.int64)
    v[:h] = val  # rows past H are 0
    v = v.reshape(hw, 32, w)
    fw = np.zeros((hw, w), np.int64)
    gw = np.zeros((hw, w), np.int64)
    for j in range(31, -1, -1):  # row 31 first
        d_hi, d_lo = hi - v[:, j], lo - v[:, j]
        assert (np.abs(d_hi) < 2**31).all() and (np.abs(d_lo) < 2**31).all()
        fw = ((fw << 1) | ((d_hi & M32) >> 31)) & M32
        gw = ((gw << 1) | ((d_lo & M32) >> 31)) & M32
    to32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))  # noqa: E731
    return to32(fw), to32(gw & ~fw & M32)


@pytest.mark.parametrize("h", [1, 33, 96])
@pytest.mark.parametrize("w", [1, 5, 70])
def test_pack_thresh_walk_matches_plain(h, w):
    rng = np.random.default_rng(h * 100 + w)
    levels = np.array([0, 128, 255, 127, 129, 254, 1], np.uint8)
    tmap = levels[rng.integers(0, len(levels), (h, w))]
    f, p = model_pack_thresh(tmap)
    want = pack_thresh_plain(torch.from_numpy(tmap))
    assert torch.equal(f, want[0]) and torch.equal(p, want[1])
    kg = rng.integers(-2**31, 2**31, (h, w), dtype=np.int64).astype(np.int32)
    kg[0, 0], kg[-1, -1] = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    for lo, hi in [(100, 900), (-5, 400), (-9, -1), (0, 0), (-2**31, 2**31 - 1)]:
        b = torch.tensor([lo, hi], dtype=torch.int32)
        f, p = model_pack_thresh(kg, (lo, hi))
        want = pack_thresh_plain(torch.from_numpy(kg), b)
        assert torch.equal(f, want[0]) and torch.equal(p, want[1])


def test_pack_thresh_modes_of_one_walk():
    """The u8 mode is the nmsq walk on the classes 2 / 1 / 0 against [0, 1]."""
    rng = np.random.default_rng(4)
    tmap = np.array([0, 128, 255, 7], np.uint8)[rng.integers(0, 4, (40, 9))]
    cls = np.where(tmap == 255, 2, np.where(tmap == 128, 1, 0)).astype(np.int32)
    for a, b in zip(model_pack_thresh(tmap), model_pack_thresh(cls, (0, 1))):
        assert torch.equal(a, b)
