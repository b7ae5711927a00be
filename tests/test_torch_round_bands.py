"""The band decomposition of the hysteresis rounds (``csrc/hyst_rounds.cu``)
as a NumPy model, against both packages' round operators.

The round kernels cut each packed (hw, w) plane into full-height column
bands of ``bw`` columns (a multiple of 32 where the launch scans, of 16 for
phase 1 alone). A scan direction that crosses bands (0, 1 and the diagonals
4-7) runs in three parts: each band scans itself with carry-in zero, giving
its local result L and the propagate product Q from its entry edge, and
publishes its exit column (L, Q); each band then folds the summaries of the
bands upstream of it into its carry-in column V (V' = L | (Q & V shifted by
dr * bw rows)); and applies G = L | (Q & V shifted along the direction).
Directions 2 and 3 stay inside a band: an in-word scan of each word and the
carry across words. The dilations run per band on the band and ``halo``
columns each side taken from the round-start state, in segments of at most
``halo`` steps, and a band changed iff its core's popcount grew.

Where a band does not fit a block's shared memory it is cut into ``ns``
stacked height segments (tiles). A tile dilates with ``ceil(halo / 32)``
word rows of vertical halo; directions 2 and 3 scan it with carry-in zero,
publish each column's (carry out, every word propagates), and after a
barrier fold the segments upstream into a carry-in and run the carries
again; a diagonal's tile publishes its exit row's (L, Q) bits, and after a
barrier carries them down the lines that enter it by that edge (the
fix-up), which makes its L and Q the full band's, so the fold and apply
follow unchanged (its carry column over ``bw / 32`` rows more each side).
The kernels clear the bits of rows at and past h when they load a plane.

Phase 1's register route (``hyst_kernel<false, false, R>``) keeps each
band's words in registers instead: its lanes are the columns of the band
and its ``halo`` = dilate_steps columns each side (zero outside the frame
and past the band's halo), 16 to a warp, each column's word rows split
between two threads of the warp (the top half, the bottom half). A step
takes the columns left and right by shuffles and, beside a warp's edge,
the column across it that the neighbouring warp published the step
before; an exact step takes the rows above and below from the thread's own
words, and across the halves from the other thread's. Once a round the
halo lanes reload from the edge slot the neighbouring bands published, and
a core thread changed iff its popcount grew.

The model below is those algorithms, step for step, on NumPy words; the
tests hold it to ``bitpack._make_ops`` of the port and of the JAX package
(and to each package's ``_scan_dir`` direction by direction) on seeded
random planes and the spiral.

Tolerance: 0. Every value is a packed word or a round count.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.ops import bitpack as jbp
from cudacam_tpu_torch.io.sources import make_spiral_thresh
from cudacam_tpu_torch.ops import bitpack as tbp

torch.set_num_threads(2)

U32 = np.uint32
ONES = U32(0xFFFFFFFF)
#: Crossing directions as (dc, dr): downstream is +dc columns and +dr rows a step.
CROSSING = {0: (1, 0), 1: (-1, 0), 4: (1, 1), 5: (-1, -1), 6: (-1, 1), 7: (1, -1)}
BANDS = (32, 64, 96)
HEIGHTS = (1, 31, 32, 33, 70)
WIDTHS = (1, 53, 130)


# -- the model ---------------------------------------------------------------


def _shl(x, s):
    return (x.astype(np.uint64) << np.uint64(s)).astype(U32) if s < 32 else np.zeros_like(x)


def _shr(x, s):
    return (x >> U32(s)) if s < 32 else np.zeros_like(x)


def vshift(v: np.ndarray, s: int) -> np.ndarray:
    """A column of words (first axis) shifted by ``s`` image rows, down for
    s > 0, zero fill: ``bitpack._shift_px`` along one column."""
    hw = v.shape[0]
    out = np.zeros_like(v)
    q, r = divmod(abs(s), 32)
    if q >= hw:
        return out
    if s >= 0:
        base = np.zeros_like(v)
        base[q:] = v[: hw - q]
        if r == 0:
            return base
        prev = np.zeros_like(v)
        prev[1:] = base[:-1]
        return _shl(base, r) | _shr(prev, 32 - r)
    base = np.zeros_like(v)
    base[: hw - q] = v[q:]
    if r == 0:
        return base
    nxt = np.zeros_like(v)
    nxt[:-1] = base[1:]
    return _shr(base, r) | _shl(nxt, 32 - r)


def bands_of(w: int, bw: int):
    """(first column, width) of each band; only the last is narrower."""
    return [(c0, min(bw, w - c0)) for c0 in range(0, w, bw)]


def segments_of(hw: int, ns: int):
    """(first word row, rows) of each height segment, within a row of each
    other: the kernel's ``band_of``."""
    return [(s * hw // ns, (s + 1) * hw // ns - s * hw // ns) for s in range(ns)]


def clear_past_h(x, h):
    """The bits of rows at and past h cleared, as the kernels load a plane."""
    x = x.copy()
    if h % 32:
        x[-1] &= U32((1 << (h % 32)) - 1)
    return x


def local_scan(g, p, dc, dr):
    """One band's scan with carry-in zero: (L, Q), both (hw, cb); along a
    row, column by column."""
    if dr:
        return diagonal_scan(g, p, dc, dr)
    cb = g.shape[1]
    order = range(cb) if dc > 0 else range(cb - 1, -1, -1)
    L, Q = g.copy(), np.zeros_like(g)
    prev = None
    for c in order:
        if prev is None:
            Q[:, c] = p[:, c]
        else:
            L[:, c] |= p[:, c] & L[:, prev]
            Q[:, c] = p[:, c] & Q[:, prev]
        prev = c
    return L, Q


def diagonal_scan(g, p, dc, dr):
    """A diagonal band scan with carry-in zero, in the kernel's three
    passes, t counting columns from the entry edge:

    1. each word row on its own: L (lines that stay in the word, carry-in
       zero), D (the propagate product from an entry at the word's entry
       bit, 0 or 31, at a column >= 1) and E (from the band's entry edge,
       staying in the word); the exit bits (31 or 0) of each as bit vectors
       over t;
    2. word row by word row, the carries as bit vectors: c_k[t] = G of the
       exit bit of the neighbouring word at column t - 1, and x_k the same
       for Q: c_k = (l | (d & (c_prev << 31))) << 1;
    3. each word row on its own again: G = L | (D & c spread over the
       word's bits), Q = E | (D & x spread)."""
    hw, cb = g.shape
    cols = [t if dc > 0 else cb - 1 - t for t in range(cb)]
    sh = (lambda v: _shl(v, 1)) if dr > 0 else (lambda v: _shr(v, 1))
    entry = U32(1) if dr > 0 else U32(0x80000000)
    ex = 31 if dr > 0 else 0
    L, E, D = g.copy(), np.zeros_like(g), np.zeros_like(g)
    for t, c in enumerate(cols):
        if t == 0:
            E[:, c] = p[:, c]
        else:
            cp = cols[t - 1]
            L[:, c] = g[:, c] | (p[:, c] & sh(L[:, cp]))
            D[:, c] = p[:, c] & (sh(D[:, cp]) | entry)
            E[:, c] = p[:, c] & sh(E[:, cp])

    def bits(X, k):
        return sum(int((int(X[k, c]) >> ex) & 1) << t for t, c in enumerate(cols))

    # A carry moves 32 columns a word row: what entered nv word rows back
    # has left the band, so each word row starts there with carry zero.
    nv = -(-cb // 32)
    mask = (1 << (32 * nv)) - 1
    carry_g, carry_q = [0] * hw, [0] * hw
    for k in range(hw):
        before = k if dr > 0 else hw - 1 - k
        cg = cq = 0
        for j in range(min(before, nv), 0, -1):
            kp = k - dr * j
            d = bits(D, kp)
            cg = ((bits(L, kp) | (d & (cg << 31))) << 1) & mask
            cq = ((bits(E, kp) | (d & (cq << 31))) << 1) & mask
        carry_g[k], carry_q[k] = cg, cq

    def spread(v, t):
        """Bit b: v at the column where the line through (b, t) entered the
        word (t - b going down, t - 31 + b going up)."""
        win = (v >> (t - 31)) if t >= 31 else (v << (31 - t))
        win &= 0xFFFFFFFF
        return U32(int(f"{win:032b}"[::-1], 2)) if dr > 0 else U32(win)

    Q = E.copy()
    for k in range(hw):
        for t, c in enumerate(cols):
            L[k, c] |= D[k, c] & spread(carry_g[k], t)
            Q[k, c] |= D[k, c] & spread(carry_q[k], t)
    return L, Q


def fold(summ, j, dc, dr, bw):
    """Band j's carry-in column from the exit summaries of the bands
    upstream of it, word by word, nearest band first, stopping where the
    product of the Qs is zero or the chain leaves the frame."""
    hw = summ[0][0].shape[0]
    up = j if dc > 0 else len(summ) - 1 - j
    v = np.zeros(hw, U32)
    for k in range(hw):
        acc_l, acc_q = U32(0), ONES
        for m in range(1, up + 1):
            kk = k - dr * (m - 1) * (bw // 32)
            if not 0 <= kk < hw:
                break
            L, Q = summ[j - dc * m]
            acc_l |= acc_q & L[kk]
            acc_q &= Q[kk]
            if not acc_q:
                break
        v[k] = acc_l
    return v


def apply_carry(L, Q, v, dc, dr):
    """G = L | (Q & carry): the carry of a pixel t columns from the entry
    edge is V shifted by dr (t + 1) rows."""
    cb = L.shape[1]
    G = L.copy()
    for t in range(cb):
        c = t if dc > 0 else cb - 1 - t
        G[:, c] |= Q[:, c] & (v if dr == 0 else vshift(v, dr * (t + 1)))
    return G


def fix_diagonal(L, Q, p, upstream, dc, dr):
    """A tile's lines that enter by its edge with the segment upstream (above
    going down, below going up), in place: ``upstream`` is that segment's
    exit row as (L, Q) bits by column; each line takes the bits at the
    column before its entry and carries them while the candidates reach."""
    hk, cb = L.shape
    nrow = 32 * hk
    ul, uq = upstream
    for t0 in range(1, cb):
        cp = t0 - 1 if dc > 0 else cb - t0
        cl, cq = int(ul[cp]), int(uq[cp])
        i = 0
        while (cl or cq) and t0 + i < cb and i < nrow:
            r = i if dr > 0 else nrow - 1 - i
            c = t0 + i if dc > 0 else cb - 1 - t0 - i
            bit = U32(1 << (r & 31))
            if not p[r >> 5, c] & bit:
                break
            if cl:
                L[r >> 5, c] |= bit
            if cq:
                Q[r >> 5, c] |= bit
            i += 1


def crossing_scan(g, p, bw, direction, ns=1):
    """A crossing direction over the whole plane: local scans on each tile,
    the exit rows and the fix-up across segments (a diagonal with ns > 1),
    summaries, fold, apply."""
    dc, dr = CROSSING[direction]
    bands, segs = bands_of(g.shape[1], bw), segments_of(g.shape[0], ns)
    assert ns == 1 or all(32 * hk >= bw for _, hk in segs)  # a line crosses one segment edge
    local = {}
    for s, (k0, hk) in enumerate(segs):
        for j, (c0, cb) in enumerate(bands):
            local[s, j] = local_scan(g[k0:k0 + hk, c0:c0 + cb], p[k0:k0 + hk, c0:c0 + cb], dc, dr)
    if dr and ns > 1:
        ex = -1 if dr > 0 else 0
        exit_rows = {key: ((L[ex] >> U32(31 if dr > 0 else 0)) & U32(1),
                           (Q[ex] >> U32(31 if dr > 0 else 0)) & U32(1))
                     for key, (L, Q) in local.items()}
        for (s, j), (L, Q) in local.items():
            if 0 <= s - dr < ns:
                k0, hk = segs[s]
                c0, cb = bands[j]
                fix_diagonal(L, Q, p[k0:k0 + hk, c0:c0 + cb], exit_rows[s - dr, j], dc, dr)
    col = -1 if dc > 0 else 0
    summ = [(np.concatenate([local[s, j][0][:, col] for s in range(ns)]),
             np.concatenate([local[s, j][1][:, col] for s in range(ns)]))
            for j in range(len(bands))]
    out = np.empty_like(g)
    mg = bw // 32 if dr and ns > 1 else 0
    for j, (c0, cb) in enumerate(bands):
        v = fold(summ, j, dc, dr, bw)
        for s, (k0, hk) in enumerate(segs):
            # The tile's carry column: its rows, and mg more each side.
            vt = np.zeros_like(v)
            lo, hi = max(0, k0 - mg), k0 + hk + mg
            vt[lo:hi] = v[lo:hi]
            L, Q = local[s, j]
            pad = np.zeros((g.shape[0], cb), U32)
            pad[k0:k0 + hk], qpad = L, np.zeros_like(pad)
            qpad[k0:k0 + hk] = Q
            out[k0:k0 + hk, c0:c0 + cb] = apply_carry(pad, qpad, vt, dc, dr)[k0:k0 + hk]
    return out


def column_carries(L, Q, cin, down):
    """Word by word down (up) each column from the carry ``cin`` (bool by
    column) into the first word: G = L | (Q & carry), the carry out its exit
    bit. Returns G and the carry out of the last word."""
    out = L.copy()
    for k in (range(L.shape[0]) if down else range(L.shape[0] - 1, -1, -1)):
        out[k] = L[k] | (Q[k] & np.where(cin, ONES, U32(0)))
        cin = ((out[k] >> U32(31 if down else 0)) & U32(1)).astype(bool)
    return out, cin


def vertical_scan(g, p, direction, ns=1):
    """Direction 2 (top->bottom) or 3 (bottom->top): each tile scans its
    words with carry-in zero (``word_scan``, then the carries), publishes each
    column's (carry out, every word propagates); each tile then folds the
    segments upstream into its carry-in and runs the carries again from its
    local result."""
    down = direction == 2
    segs = segments_of(g.shape[0], ns)
    local = []
    for k0, hk in segs:
        L, Q = word_scan(g[k0:k0 + hk], p[k0:k0 + hk], down)
        G, cout = column_carries(L, Q, np.zeros(g.shape[1], bool), down)
        full = (((Q >> U32(31 if down else 0)) & U32(1)) == 1).all(axis=0)
        local.append((G, Q, cout, full))
    out = np.empty_like(g)
    dr = 1 if down else -1
    for s, (k0, hk) in enumerate(segs):
        G, Q, _, _ = local[s]
        cin, acc_q = np.zeros(g.shape[1], bool), np.ones(g.shape[1], bool)
        u = s - dr
        while 0 <= u < ns:
            cin |= acc_q & local[u][2]
            acc_q &= local[u][3]
            u -= dr
        out[k0:k0 + hk] = column_carries(G, Q, cin, down)[0]
    return out


def word_scan(g, p, down):
    """Each word's own scan of direction 2 (``down``) or 3 with carry-in zero
    (five doubling steps): L, and the propagate product Q from its entry
    bit."""
    L, Q, pp = g.copy(), p.copy(), p.copy()
    for s in (1, 2, 4, 8, 16):
        if down:
            L |= pp & _shl(L, s)
            Q &= _shl(Q, s) | U32((1 << s) - 1)
            pp &= _shl(pp, s)
        else:
            L |= pp & _shr(L, s)
            Q &= _shr(Q, s) | U32(0xFFFFFFFF ^ (0xFFFFFFFF >> s))
            pp &= _shr(pp, s)
    return L, Q


def scan_dir(g, p, bw, direction, ns=1):
    if direction in (2, 3):
        return vertical_scan(g, p, direction, ns)
    return crossing_scan(g, p, bw, direction, ns)


def band_scans(g, p, bw, ns=1):
    for d in range(8):
        g = scan_dir(g, p, bw, d, ns)
    return g


def _row_or(a):
    v = a.copy()
    v[:, 1:] |= a[:, :-1]
    v[:, :-1] |= a[:, 1:]
    return v


def dilate_region(a, p, steps, s0, total):
    """Steps s0 + 1 .. s0 + steps of a round on a band's region (core and
    halo): Jacobi, every 8th and the round's last exact across words."""
    for i in range(s0 + 1, s0 + steps + 1):
        v = _row_or(a)
        h = v | _shl(v, 1) | _shr(v, 1)
        if i % 8 == 0 or i == total:
            h[1:] |= _shr(v[:-1], 31)
            h[:-1] |= _shl(v[1:], 31)
        a = a | (p & h)
    return a


def band_dilates(f, p, bw, halo, dilate_steps, ns=1):
    """A round's dilations tile by tile, in segments of at most ``halo``
    steps: each tile on its columns and ``halo`` more each side, and with
    height segments on its rows and ``ceil(halo / 32)`` more above and below,
    from the segment-start plane (zero outside the frame); its core is
    exact. Returns the plane and whether some tile's popcount grew."""
    hw, w = f.shape
    vh = -(-halo // 32) if ns > 1 else 0
    tiles = [(k0, hk, c0, cb) for k0, hk in segments_of(hw, ns) for c0, cb in bands_of(w, bw)]
    cur = f
    for s0 in range(0, dilate_steps, halo):
        n = min(halo, dilate_steps - s0)
        pad_f = np.zeros((hw + 2 * vh, w + 2 * halo), U32)
        pad_p = np.zeros_like(pad_f)
        pad_f[vh:vh + hw, halo:halo + w], pad_p[vh:vh + hw, halo:halo + w] = cur, p
        nxt = np.empty_like(cur)
        for k0, hk, c0, cb in tiles:
            rows, cols = slice(k0, k0 + hk + 2 * vh), slice(c0, c0 + cb + 2 * halo)
            region = dilate_region(pad_f[rows, cols], pad_p[rows, cols], n, s0, dilate_steps)
            nxt[k0:k0 + hk, c0:c0 + cb] = region[vh:vh + hk, halo:halo + cb]
        cur = nxt
    grew = any(_popc(cur[k0:k0 + hk, c0:c0 + cb]) != _popc(f[k0:k0 + hk, c0:c0 + cb])
               for k0, hk, c0, cb in tiles)
    return cur, grew


def _popc(x):
    return int(np.unpackbits(x.view(np.uint8)).sum())


def band_converge(f, p, h, bw, halo, dilate_steps, scan_after, max_iters, ns=1):
    """Both phases' round loops on the band model (bitpack.converge_packed's
    round counting and stop test) on the planes as the kernels load them:
    (plane, rounds, still growing)."""
    f, p = clear_past_h(f, h), clear_past_h(p, h)
    cap = min(scan_after, max_iters)
    it, grew = 0, True
    while True:
        f, grew = band_dilates(f, p, bw, halo, dilate_steps, ns)
        it += 1
        if not (grew and it < cap):
            break
    while grew and it < max_iters:
        nf, _ = band_dilates(f, p, bw, halo, dilate_steps, ns)
        nf = band_scans(nf, p, bw, ns)
        grew, f, it = _popc(nf) != _popc(f), nf, it + 1
    return f, it, grew


#: Columns a warp takes side by side on the register route (lanes 0-15 the
#: top half of their word rows, lanes 16-31 the bottom half).
WARP_COLS = 16


def shfl(x, up):
    """``__shfl_up_sync(FULL, x, 1, 16)`` (up) or ``__shfl_down_sync(FULL, x,
    1, 16)`` on x (columns, ...) of whole warps: each column's thread gets
    the word of the column before (after) it in its warp; a thread whose
    source lies outside its warp gets its own."""
    y = x.copy()
    i = np.arange(x.shape[0]) % WARP_COLS
    if up:
        take = i[1:] != 0
        y[1:][take] = x[:-1][take]
    else:
        take = i[:-1] != WARP_COLS - 1
        y[:-1][take] = x[1:][take]
    return y


def warp_sides(lanes):
    """The columns whose threads publish their warp's edge columns (the
    first and the last of each warp)."""
    return np.isin(np.arange(lanes) % WARP_COLS, (0, WARP_COLS - 1))


def reg_step(f, p, pub, exact):
    """One dilation step of the register route on a band's lanes: f, p
    (lanes, 2, H) words, the top and the bottom half of each column's rows
    (two threads); pub the warps' edge columns as published the step
    before (read only beside a warp's edge). The first column of a warp
    past the first ORs in the column of the warp before's last, the last
    column of a warp before the last the next warp's first; an exact step
    carries across words from the thread's own rows above and below, and
    across the halves from the other half's first and last rows (the
    kernel's ``__shfl_xor_sync`` by 16 lanes)."""
    n = f.shape[0]
    t = np.arange(n)
    e = np.zeros_like(f)
    left = (t % WARP_COLS == 0) & (t >= WARP_COLS)
    right = (t % WARP_COLS == WARP_COLS - 1) & (t < n - 1)
    e[left] = pub[t[left] - 1]
    e[right] = pub[t[right] + 1]
    v = f | shfl(f, True) | shfl(f, False) | e
    h = v | _shl(v, 1) | _shr(v, 1)
    if exact:
        h[:, :, 1:] |= _shr(v[:, :, :-1], 31)
        h[:, :, :-1] |= _shl(v[:, :, 1:], 31)
        first, last = v[:, 1, 0], v[:, 0, -1]  # exchanged across the halves
        h[:, 0, -1] |= _shl(first, 31)
        h[:, 1, 0] |= _shr(last, 31)
    return f | (p & h)


def reg_phase1(f, p, h, steps, lanes, scan_after, max_iters, edge=None, fresh=True):
    """Phase 1 on the register route: bands of ``lanes - 2 steps`` columns,
    each with ``steps`` halo columns, ``lanes`` columns of R = ceil(hw / 2) 2
    word rows, split between two threads (a row past hw stays 0).
    ``edge``: the two edge slots' starting words (the kernel's scratch,
    never read before written). ``fresh`` False publishes the warps' edge
    columns once a round only: the wrong exchange. Returns (plane, rounds,
    still growing, each round's (plane before, plane after))."""
    f, p = clear_past_h(f, h), clear_past_h(p, h)
    hw, w = f.shape
    halo, bw, r_rows = steps, lanes - 2 * steps, -(-hw // 2) * 2
    edge = np.zeros((2, hw, w), U32) if edge is None else edge.copy()
    t, sides = np.arange(lanes), warp_sides(lanes)

    def halves(x):
        return x.reshape(x.shape[0], 2, r_rows // 2)

    bands = []
    for c0, cb in bands_of(w, bw):
        cols = c0 - halo + t
        inside = (cols >= 0) & (cols < w) & (t < cb + 2 * halo)
        core = (t >= halo) & (t < halo + cb)
        F, P = np.zeros((lanes, r_rows), U32), np.zeros((lanes, r_rows), U32)
        F[inside, :hw], P[inside, :hw] = f[:, cols[inside]].T, p[:, cols[inside]].T
        pub = core & ((t < 2 * halo) | (t >= cb))  # core lanes within halo of the band's edges
        bands.append(dict(cols=cols, halo=inside & ~core, core=core, pub=pub, F=halves(F),
                          P=halves(P), pc=np.where(core, [_popc(r) for r in F], 0)))

    def plane():
        out = np.zeros_like(f)
        for b in bands:
            out[:, b["cols"][b["core"]]] = b["F"].reshape(lanes, r_rows)[b["core"], :hw].T
        return out

    it, rounds = 0, []
    while True:
        before, grew = plane(), False
        for b in bands:
            F, P = b["F"], b["P"]
            if it > 0:
                whole = F.reshape(lanes, r_rows).copy()
                whole[b["halo"], :hw] = edge[(it - 1) & 1][:, b["cols"][b["halo"]]].T
                F = halves(whole)
            pub = np.where(sides[:, None, None], F, 0)
            for s in range(1, steps + 1):
                F = reg_step(F, P, pub, s % 8 == 0 or s == steps)
                if fresh:
                    pub = np.where(sides[:, None, None], F, 0)
            whole = F.reshape(lanes, r_rows)
            assert not whole[:, hw:].any()
            pc = np.where(b["core"], [_popc(r) for r in whole], 0)
            grew |= bool((pc != b["pc"]).any())
            b["F"], b["pc"] = F, pc
        for b in bands:
            edge[it & 1][:, b["cols"][b["pub"]]] = b["F"].reshape(lanes, r_rows)[b["pub"], :hw].T
        it += 1
        rounds.append((before, plane()))
        if not (grew and it < min(scan_after, max_iters)):
            return plane(), it, grew, rounds


# -- the references ----------------------------------------------------------


def _port_ops(h, w, steps):
    return tbp._make_ops(h, w, steps)


def _torch(x):
    return torch.from_numpy(x.astype(np.int64))


def _np(x):
    return x.numpy().astype(U32)


def port_scans(g, p, h):
    _, scans = _port_ops(h, g.shape[1], 1)
    return _np(scans(_torch(g), _torch(p)))


def jax_scans(g, p, h):
    _, scans = jbp._make_ops(h, g.shape[1], 1)
    return np.asarray(scans(jnp.asarray(g), jnp.asarray(p))).astype(U32)


def _directions(mod, h, w):
    """The 8 directions of ``mod._make_ops`` as (shift, steps), built from the
    module's own primitives in its order."""
    sc, sp = mod._shift_cols, mod._shift_px
    hs, vs, ds = (mod._doubling_steps(w), mod._doubling_steps(h),
                  mod._doubling_steps(min(h, w)))
    return [
        (lambda x, s: sc(x, s), hs), (lambda x, s: sc(x, -s), hs),
        (lambda x, s: sp(x, s), vs), (lambda x, s: sp(x, -s), vs),
        (lambda x, s: sc(sp(x, s), s), ds), (lambda x, s: sc(sp(x, -s), -s), ds),
        (lambda x, s: sc(sp(x, s), -s), ds), (lambda x, s: sc(sp(x, -s), s), ds),
    ]


def port_scan_dir(g, p, h, d):
    shift, steps = _directions(tbp, h, g.shape[1])[d]
    return _np(tbp._scan_dir(_torch(g), _torch(p), shift, steps))


def jax_scan_dir(g, p, h, d):
    shift, steps = _directions(jbp, h, g.shape[1])[d]
    return np.asarray(jbp._scan_dir(jnp.asarray(g), jnp.asarray(p), shift, steps)).astype(U32)


# -- inputs ------------------------------------------------------------------


def _pack(mask):
    return _np(tbp.pack_mask(torch.from_numpy(mask)))


def planes(h, w, kind, seed=0):
    """(F, P) packed planes of an h x w map, rows past h zero as every pack
    leaves them: ``random`` is a seeded map dense in candidates (long runs
    across bands), ``spiral`` the spiral threshold map (one chain), ``lines``
    long candidate diagonals both ways with a few seeded FINAL pixels on
    them (a seed's line crosses band and segment edges with nothing else to
    carry it)."""
    if kind == "spiral":
        t = make_spiral_thresh(h, w)
        return _pack(t == 255), _pack(t == 128)
    if kind == "lines":
        r, c = np.mgrid[:h, :w]
        cand = ((r - c) % 7 == 0) | ((r + c) % 11 == 0)
        seed = cand & (np.random.default_rng(seed + 7 * h + w).random((h, w)) < 0.004)
        return _pack(seed), _pack(cand & ~seed)
    u = np.random.default_rng(seed + 1000 * h + w).random((h, w))
    return _pack(u < 0.04), _pack((u >= 0.04) & (u < 0.75))


SHAPES = [(h, w) for h in HEIGHTS for w in WIDTHS]


# -- tests -------------------------------------------------------------------


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("bw", BANDS)
def test_each_direction_matches_both_packages(h, w, bw):
    """Every direction on its own, from a dilated state, equals each
    package's doubling scan of that direction."""
    f, p = planes(h, w, "random")
    g = band_dilates(f, p, bw, 4, 4)[0]
    for d in range(8):
        want = port_scan_dir(g, p, h, d)
        assert np.array_equal(scan_dir(g, p, bw, d), want), d
        assert np.array_equal(jax_scan_dir(g, p, h, d), want), d


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("kind", ["random", "spiral"])
def test_band_scans_match_make_ops(h, w, bw, kind):
    """The 8 directions in order equal ``_make_ops``'s scans of both packages."""
    f, p = planes(h, w, kind)
    g = band_dilates(f, p, bw, 16, 16)[0]
    got = band_scans(g, p, bw)
    assert np.array_equal(got, port_scans(g, p, h))
    assert np.array_equal(got, jax_scans(g, p, h))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("bw", (16,) + BANDS)
@pytest.mark.parametrize("steps,halo", [(1, 1), (9, 9), (16, 16), (40, 32), (40, 13)])
def test_band_dilates_match_make_ops(h, w, bw, steps, halo):
    """The banded dilations (one segment where the halo covers the steps,
    else segments of ``halo`` steps) equal ``_make_ops``'s dilates of both
    packages; a band's popcount grew iff the plane changed."""
    f, p = planes(h, w, "random", seed=steps)
    halo = min(halo, bw)
    got, grew = band_dilates(f, p, bw, halo, steps)
    dil, _ = _port_ops(h, w, steps)
    want = _np(dil(_torch(f), _torch(p)))
    jdil, _ = jbp._make_ops(h, w, steps)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(jdil(jnp.asarray(f), jnp.asarray(p))).astype(U32), want)
    assert grew == bool((want != f).any())


@pytest.mark.parametrize("h,w,bw", [(70, 130, 32), (70, 130, 64), (33, 53, 32), (64, 97, 32)])
@pytest.mark.parametrize("max_iters", [1, 2, 5, 100])
def test_band_rounds_match_converge_packed(h, w, bw, max_iters):
    """Whole round loops on the spiral (phase 1 to round 2, then phase 2 to
    the cap) equal the port's converge_packed, cut off by the cap included."""
    f, p = planes(h, w, "spiral")
    got, it, grew = band_converge(f, p, h, bw, 16, 16, 2, max_iters)
    want, wit, wgrew = tbp.converge_packed(
        tbp.from_words(_torch(f)), tbp.from_words(_torch(p)), h, w,
        dilate_steps=16, scan_after=2, max_iters=max_iters)
    assert np.array_equal(got, _np(tbp.to_words(want)))
    assert (it, grew) == (wit, bool(wgrew))


#: (h, w, height segments): every segment 32 hk >= 96 rows, so a diagonal line
#: of the widest band below crosses one segment edge at most, as the kernel's
#: MIN_SEG-row segments guarantee for its widest band.
SEGMENTED = [(200, 130, 2), (300, 130, 3), (300, 53, 2), (289, 97, 3)]


@pytest.mark.parametrize("h,w,ns", SEGMENTED)
@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("kind", ["random", "lines"])
def test_segmented_directions_match_both_packages(h, w, ns, bw, kind):
    """With stacked height segments every direction on its own, from a
    dilated state, still equals each package's doubling scan."""
    f, p = planes(h, w, kind)
    g = band_dilates(f, p, bw, 4, 4, ns)[0] if kind == "random" else f
    for d in range(8):
        want = port_scan_dir(g, p, h, d)
        assert np.array_equal(scan_dir(g, p, bw, d, ns), want), d
        assert np.array_equal(jax_scan_dir(g, p, h, d), want), d


@pytest.mark.parametrize("h,w,ns", SEGMENTED)
@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("kind", ["random", "spiral", "lines"])
def test_segmented_scans_match_make_ops(h, w, ns, bw, kind):
    f, p = planes(h, w, kind)
    g = band_dilates(f, p, bw, 16, 16, ns)[0]
    got = band_scans(g, p, bw, ns)
    assert np.array_equal(got, port_scans(g, p, h))
    assert np.array_equal(got, jax_scans(g, p, h))


@pytest.mark.parametrize("h,w,ns", SEGMENTED)
@pytest.mark.parametrize("bw", (16,) + BANDS)
@pytest.mark.parametrize("steps,halo", [(1, 1), (16, 16), (40, 32), (40, 40), (70, 64)])
def test_segmented_dilates_match_make_ops(h, w, ns, bw, steps, halo):
    """Tiles with a vertical halo of ceil(halo / 32) word rows (two where the
    halo passes 32 columns) dilate as the whole plane does."""
    f, p = planes(h, w, "random", seed=steps)
    halo = min(halo, bw)
    got, grew = band_dilates(f, p, bw, halo, steps, ns)
    dil, _ = _port_ops(h, w, steps)
    want = _np(dil(_torch(f), _torch(p)))
    jdil, _ = jbp._make_ops(h, w, steps)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(jdil(jnp.asarray(f), jnp.asarray(p))).astype(U32), want)
    assert grew == bool((want != f).any())


@pytest.mark.parametrize("h,w,ns,bw", [(300, 130, 3, 32), (200, 97, 2, 64)])
@pytest.mark.parametrize("max_iters", [1, 2, 30])
def test_segmented_rounds_match_converge_packed(h, w, ns, bw, max_iters):
    """Whole round loops on the spiral over stacked segments equal the
    port's converge_packed, cut off by the cap included."""
    f, p = planes(h, w, "spiral")
    got, it, grew = band_converge(f, p, h, bw, 16, 16, 2, max_iters, ns)
    want, wit, wgrew = tbp.converge_packed(
        tbp.from_words(_torch(f)), tbp.from_words(_torch(p)), h, w,
        dilate_steps=16, scan_after=2, max_iters=max_iters)
    assert np.array_equal(got, _np(tbp.to_words(want)))
    assert (it, grew) == (wit, bool(wgrew))


def _junk_past_h(x, h, seed):
    """x with random bits in the rows at and past h of its last word row."""
    x = x.copy()
    junk = np.random.default_rng(seed).integers(0, 2**32, x.shape[1], dtype=np.uint64).astype(U32)
    x[-1] |= junk & ~U32((1 << (h % 32)) - 1)
    return x


@pytest.mark.parametrize("h,w,ns", [(70, 53, 1), (33, 130, 1), (300, 97, 3)])
def test_rows_past_h_are_not_read(h, w, ns):
    """Bits in the rows at and past h (which every pack leaves zero) change
    nothing: the band model, as the kernels load planes, and the plain
    round wrappers both work on the h x w image and leave those rows zero."""
    from cudacam_tpu_torch.ops.cuda import megakernel as mk

    f, p = planes(h, w, "spiral")
    fj, pj = _junk_past_h(f, h, 1), _junk_past_h(p, h, 2)
    assert (fj != f).any() and (pj != p).any()
    want, wit, wgrew = tbp.converge_packed(
        tbp.from_words(_torch(f)), tbp.from_words(_torch(p)), h, w,
        dilate_steps=16, scan_after=2, max_iters=40)
    got, it, grew = band_converge(fj, pj, h, 32, 16, 16, 2, 40, ns)
    assert np.array_equal(got, _np(tbp.to_words(want))) and (it, grew) == (wit, bool(wgrew))
    ft, pt = tbp.from_words(_torch(fj)), tbp.from_words(_torch(pj))
    p_before, flags = pt.clone(), torch.zeros((2, 2), dtype=torch.int32)
    mk.hyst_phase1(ft, pt, flags, h, dilate_steps=16, scan_after=2, max_iters=40)
    mk.hyst_phase2(ft, pt, flags, h, dilate_steps=16, max_iters=40)
    assert torch.equal(ft, want) and flags[1].tolist() == [wit, int(wgrew)]
    assert torch.equal(pt, p_before)  # the CANDIDATE planes are not written


#: (dilate_steps, lanes a band): bands of lanes - 2 dilate_steps columns
#: (16, 48, 32, 128, 16, 64), in three to ten warps of 16 columns.
REG_LAYOUTS = [(8, 32), (8, 64), (16, 64), (16, 160), (32, 80), (32, 128)]
#: Ragged last bands (53 columns under one band of most layouts) and h % 32 in 6, 1, 31, 0.
REG_SHAPES = [(70, 130), (33, 53), (31, 97), (64, 161)]


@pytest.mark.parametrize("h,w", REG_SHAPES)
@pytest.mark.parametrize("steps,lanes", REG_LAYOUTS)
@pytest.mark.parametrize("kind", ["random", "spiral"])
def test_register_route_matches_make_ops(h, w, steps, lanes, kind):
    """Every round of the register route's phase 1 equals both packages'
    ``_make_ops`` dilate round on the same plane, and its round loop (the
    popcount change test, the cap) the port's ``converge_phase1``; the
    edge slots start as garbage."""
    f, p = planes(h, w, kind, seed=steps)
    junk = np.random.default_rng(lanes).integers(0, 2**32, (2,) + f.shape, dtype=np.uint64)
    got, it, grew, rounds = reg_phase1(f, p, h, steps, lanes, 6, 100, edge=junk.astype(U32))
    dil, _ = _port_ops(h, w, steps)
    jdil, _ = jbp._make_ops(h, w, steps)
    for before, after in rounds:
        want = _np(dil(_torch(before), _torch(p)))
        assert np.array_equal(after, want)
        assert np.array_equal(np.asarray(jdil(jnp.asarray(before), jnp.asarray(p))).astype(U32),
                              want)
    wf, wit, wgrew = tbp.converge_phase1(tbp.from_words(_torch(f)), tbp.from_words(_torch(p)),
                                         h, w, steps, 6, 100)
    assert np.array_equal(got, _np(tbp.to_words(wf)))
    assert (it, grew) == (wit, wgrew)


def test_register_route_needs_each_steps_edge_columns():
    """A candidate row that crosses the warps' edges: the register route
    equals ``_make_ops``, and the same route with the warps' edge columns
    published once a round, not after each step, does not."""
    h, w, steps, lanes = 32, 160, 16, 160
    cand = np.zeros((h, w), bool)
    cand[5, :] = True
    seed = np.zeros((h, w), bool)
    seed[5, 0] = True
    f, p = _pack(seed), _pack(cand & ~seed)
    dil, _ = _port_ops(h, w, steps)
    want = _np(dil(_torch(f), _torch(p)))
    got = reg_phase1(f, p, h, steps, lanes, 1, 1)[0]
    stale = reg_phase1(f, p, h, steps, lanes, 1, 1, fresh=False)[0]
    assert np.array_equal(got, want) and not np.array_equal(stale, want)


def test_register_route_carries_across_the_halves():
    """A candidate column that crosses the row where a column's two threads
    meet (row 32 R / 2 of the image): the register route equals
    ``_make_ops``, exact steps carrying the seed across the halves."""
    h, w, steps = 150, 40, 16  # hw 5, R 6: threads of 3 word rows, rows 0-95 and 96-191
    cand = np.zeros((h, w), bool)
    cand[:, 20] = True
    seed = np.zeros((h, w), bool)
    seed[100, 20] = True
    f, p = _pack(seed), _pack(cand & ~seed)
    dil, _ = _port_ops(h, w, steps)
    want = _np(dil(_torch(f), _torch(p)))
    got = reg_phase1(f, p, h, steps, 64, 1, 1)[0]
    assert np.array_equal(got, want) and _popc(want[2]) > 0  # reached row 95 and above
