"""The halo refresh on resident bands (``csrc/halo.cuh``: ``publish_band``,
``apply_band``, the step of ``sharded_loop_kernel`` that replaces the strip
exchange) as a NumPy model, against the port's ``exchange_packed`` and the
JAX package's under ``shard_map``.

In the loop kernel every tile's (hw, w) plane is cut into column bands of
``bw`` columns and, for tall planes, ``ns`` stacked height segments; each
block keeps its band in shared memory. Before one grid barrier each band
publishes, from its own words as they stand, the word rows its tile's row
strips span and its part of the tile's first and last k core lanes.
After it each band computes every word of its own that the refresh writes,
one thread a word: the strips of the tiles above and below placed in its
halo rows, and in its halo lanes the neighbour's edge lanes ORed with what
the neighbour's own row step places there (the corners). The model below is
that, band by band, with the published scratch starting as garbage, so a
word that no band published but some band reads shows up as a difference.

The same functions run on the planes in global memory in two more places,
each tile one band (``publish_planes`` / ``apply_planes``; how the grid's
threads split a band's words changes no word): the loop kernel's prologue
(both planes published from one snapshot, a scratch each, one barrier,
both applied, then the flag "some FINAL bit new, or some tile still
growing"), which stands for the two exchanges before the reference's round
loop; and the standalone ``halo_exchange`` (``csrc/halo.cu``, one plane).
:func:`prologue` models both, held to the port's two ``exchange_packed``
calls, to the JAX ``exchange_packed`` under ``shard_map`` and to
``sharded_loop_plain`` at a budget of 0.

Tolerance: 0. Every value is a packed word, a count of new bits or a flag.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cudacam_tpu.parallel import packed_halo as jph
from cudacam_tpu.parallel.mesh import make_mesh as jax_mesh
from cudacam_tpu_torch.ops import packed_strips as ps
from cudacam_tpu_torch.ops.cuda.halo import halo_exchange_plain
from cudacam_tpu_torch.parallel.packed_halo import sharded_loop, sharded_loop_plain

U32 = np.uint32
FULL = 0xFFFFFFFF


def _word_mask(b: int, cap: int, wi: int) -> int:
    lo = max(b, wi * 32) - wi * 32
    hi = min(cap, b + 32, (wi + 1) * 32) - wi * 32
    if hi <= lo:
        return 0
    return FULL if hi - lo >= 32 else ((1 << (hi - lo)) - 1) << lo


class Model:
    """halo.cuh's resident form for a (nb, ny, nx) mesh of ``geo`` tiles."""

    def __init__(self, geo, grid, rng):
        self.g, (self.nb, self.ny, self.nx) = geo, grid
        self.T, self.hw, self.w = self.nb * self.ny * self.nx, geo.hw, geo.ext_w
        # the scratch starts as garbage: every word read must have been published
        self.rows = rng.integers(0, 2**32, (self.T, 4, self.w), dtype=np.uint64)
        self.lanes = rng.integers(0, 2**32, (self.T, 2, self.hw, 64), dtype=np.uint64)

    def strip_row(self, s):
        return self.g.e_top if s else self.g.e_top + self.g.h_loc - 32

    def strip_word(self, s):
        b = self.strip_row(s)
        return 0 if b < 0 else b >> 5

    def strip_at(self, u, s, c):
        b = self.strip_row(s)
        r = self.rows[u, 2 * s]
        if b < 0:
            return (int(r[c]) << -b) & FULL
        q, sh = b >> 5, b & 31
        v = int(r[c])
        if sh:
            nxt = int(self.rows[u, 2 * s + 1, c]) if q + 1 < self.hw else 0
            v = (v >> sh) | ((nxt << (32 - sh)) & FULL)
        return v

    def placed(self, strip, b, k):
        cap = self.g.ext_h
        if b < 0:
            strip >>= -b
            b = 0
        if b >= cap:
            return 0
        q, r = b >> 5, b & 31
        if k == q:
            return ((strip << r) & FULL if r else strip) & _word_mask(b, cap, q)
        if r and k == q + 1 and q + 1 < self.hw:
            return (strip >> (32 - r)) & _word_mask(b, cap, q + 1)
        return 0

    def row_part(self, t, k, c):
        g, i = self.g, (t // self.nx) % self.ny
        v = 0
        if i > 0:
            v |= self.placed(self.strip_at(t - self.nx, 0, c), g.e_top - 32, k)
        if i < self.ny - 1:
            v |= self.placed(self.strip_at(t + self.nx, 1, c), g.e_top + g.h_loc, k)
        return v

    def lane_part(self, t, k, c):
        g, j = self.g, t % self.nx
        kl, c_r = min(64, g.e_left), g.e_left + g.w_loc
        if j > 0 and g.e_left - kl <= c < g.e_left:
            l = c - (g.e_left - kl)
            return int(self.lanes[t - 1, 1, k, l]) | self.row_part(t - 1, k, c_r - kl + l)
        if j < self.nx - 1 and c_r <= c < c_r + kl:
            l = c - c_r
            return int(self.lanes[t + 1, 0, k, l]) | self.row_part(t + 1, k, g.e_left + l)
        return 0

    def publish(self, x, t, k0, hk, c0, cb):
        g, i, j = self.g, (t // self.nx) % self.ny, t % self.nx
        for s in range(2 if self.ny > 1 else 0):
            if (i == self.ny - 1) if s == 0 else (i == 0):
                continue
            b = self.strip_row(s)
            for jj in range(2 if b > 0 and b & 31 else 1):  # the second where it starts mid-word
                k = self.strip_word(s) + jj
                if k0 <= k < k0 + hk and k < self.hw:
                    self.rows[t, 2 * s + jj, c0:c0 + cb] = x[t, k, c0:c0 + cb]
        if self.nx == 1:
            return
        kl, c_r = min(64, g.e_left), g.e_left + g.w_loc
        for side in range(2):
            if (j == 0) if side == 0 else (j == self.nx - 1):
                continue
            lo = c_r - kl if side else g.e_left
            s0, s1 = max(lo, c0), min(lo + kl, c0 + cb)
            if s1 > s0:
                self.lanes[t, side, k0:k0 + hk, s0 - lo:s1 - lo] = x[t, k0:k0 + hk, s0:s1]

    def apply(self, x, t, k0, hk, c0, cb):
        """ORs in the band's words; returns the new bits. Also checks that
        no word is written twice (one thread a word)."""
        g, i, j = self.g, (t // self.nx) % self.ny, t % self.nx
        rows = [-1] * 4
        for s in range(2):
            frm = self.ny > 1 and (i > 0 if s == 0 else i < self.ny - 1)
            b = max(g.e_top - 32 if s == 0 else g.e_top + g.h_loc, 0)
            for jj in range(2):
                k = (b >> 5) + jj
                ok = (frm and b < g.ext_h and (jj == 0 or b & 31) and k0 <= k < k0 + hk
                      and k < self.hw)
                rows[2 * s + jj] = k if ok else -1
        for m in range(1, 4):
            for q in range(m):
                if rows[m] == rows[q]:
                    rows[m] = -1
        kl, c_r = min(64, g.e_left), g.e_left + g.w_loc
        l0, l1 = (max(c0, g.e_left - kl), min(c0 + cb, g.e_left)) if j > 0 else (0, 0)
        r0, r1 = (max(c0, c_r), min(c0 + cb, c_r + kl)) if j < self.nx - 1 else (0, 0)
        nl, nrt = max(l1 - l0, 0), max(r1 - r0, 0)
        nlanes = nl + nrt if self.nx > 1 else 0
        fresh, seen = 0, set()

        def put(k, c, v):
            nonlocal fresh
            assert (k, c) not in seen and k0 <= k < k0 + hk and c0 <= c < c0 + cb
            seen.add((k, c))
            nb = v & ~int(x[t, k, c]) & FULL
            x[t, k, c] |= U32(nb)
            fresh += bin(nb).count("1")

        for m in range(4):
            if rows[m] < 0:
                continue
            for c in range(c0, c0 + cb):
                put(rows[m], c, self.row_part(t, rows[m], c) | (self.lane_part(t, rows[m], c)
                                                                if nlanes else 0))
        for kk in range(hk):
            k = k0 + kk
            if k in rows:
                continue
            for l in range(nlanes):
                c = l0 + l if l < nl else r0 + (l - nl)
                put(k, c, self.lane_part(t, k, c))
        return fresh


def bands(hw, w, bw, ns):
    """(k0, hk, c0, cb) of every band: bw columns, ns height segments."""
    out = []
    for s in range(ns):
        k0, k1 = s * hw // ns, (s + 1) * hw // ns
        for c0 in range(0, w, bw):
            out.append((k0, k1 - k0, c0, min(bw, w - c0)))
    return out


def refresh_resident(x, geo, grid, bw, ns, seed=0):
    """The refresh on resident bands: (planes, (T,) new bits of each tile)."""
    m = Model(geo, grid, np.random.default_rng(seed))
    x = x.copy()
    tiles = bands(geo.hw, geo.ext_w, bw, ns)
    for t in range(m.T):
        for band in tiles:
            m.publish(x, t, *band)
    new = np.zeros(m.T, np.int64)
    for t in range(m.T):
        for band in tiles:
            new[t] += m.apply(x, t, *band)
    return x, new


def _random_planes(rng, shape, ext_h):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    if ext_h % 32:
        w[..., -1, :] &= U32((1 << (ext_h % 32)) - 1)
    return w


def _to_torch(words):
    return torch.from_numpy(np.ascontiguousarray(words, U32).view(np.int32))


#: (frame, (nb, ny, nx), band width, height segments): e_top 32 and less
#: (8, 12, 20 rows a tile), strips that start mid-word, two halo slots in one
#: word, core lanes over two bands, bands narrower than the halo lanes, a
#: lane strip spanning a segment edge, one tile a row or a column.
CASES = [
    ((64, 96), (1, 2, 2), 32, 1), ((64, 96), (1, 2, 2), 64, 1), ((16, 24), (1, 2, 2), 32, 1),
    ((40, 200), (1, 2, 1), 32, 2), ((24, 150), (1, 3, 2), 32, 1), ((72, 200), (2, 2, 4), 64, 1),
    ((200, 320), (1, 2, 2), 96, 3), ((96, 384), (1, 1, 4), 32, 1), ((256, 384), (1, 4, 1), 32, 2),
    ((66, 260), (1, 3, 3), 64, 2), ((8, 8), (1, 2, 2), 32, 1), ((300, 130), (1, 2, 2), 32, 4),
]


@pytest.mark.parametrize("frame,grid,bw,ns", CASES)
def test_resident_refresh_matches_exchange_packed(frame, grid, bw, ns):
    nb, ny, nx = grid
    geo = ps.make_geo(frame[0] // ny, frame[1] // nx, ny=ny, nx=nx)
    rng = np.random.default_rng(frame[0] * 7 + frame[1] + bw + ns)
    x = _random_planes(rng, (nb * ny * nx, geo.hw, geo.ext_w), geo.ext_h)
    got, new = refresh_resident(x, geo, grid, bw, min(ns, geo.hw))
    want, want_new = ps.exchange_packed(_to_torch(x), geo, ny, nx, ps.local_shift(ny, nx))
    np.testing.assert_array_equal(got, want.numpy().view(U32))
    np.testing.assert_array_equal(new > 0, want_new.numpy())
    # the new bits are those the refresh set: the change test counts from here
    np.testing.assert_array_equal(
        new, [int(np.unpackbits((got[t] ^ x[t]).view(np.uint8)).sum()) for t in range(len(x))])
    # a second refresh brings nothing new
    again, new2 = refresh_resident(got, geo, grid, bw, min(ns, geo.hw), seed=1)
    np.testing.assert_array_equal(again, got)
    assert not new2.any()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("frame,grid,bw,ns", [c for c in CASES if c[1][0] == 1
                                              and c[1][1] * c[1][2] <= 8][:4])
def test_resident_refresh_matches_jax(frame, grid, bw, ns):
    """The same against the JAX ``exchange_packed`` under ``shard_map``."""
    _, ny, nx = grid
    geo = ps.make_geo(frame[0] // ny, frame[1] // nx, ny=ny, nx=nx)
    jgeo = jph.make_geo(geo.h_loc, geo.w_loc, granule=False, ny=ny, nx=nx)
    x = _random_planes(np.random.default_rng(ny * 10 + nx), (ny * nx, geo.hw, geo.ext_w), geo.ext_h)
    got, new = refresh_resident(x, geo, grid, bw, min(ns, geo.hw))
    g = np.concatenate([x, np.zeros((ny * nx, 1, geo.ext_w), U32)], axis=1)  # the guard row
    g = g.reshape(ny, nx, geo.hw + 1, geo.ext_w).transpose(0, 2, 1, 3)
    g = jnp.asarray(g.reshape(ny * (geo.hw + 1), nx * geo.ext_w))
    mesh = jax_mesh(batch=1, rows=ny, cols=nx, devices=jax.devices()[: ny * nx])

    def exchange(xs):
        out, fresh = jph.exchange_packed(xs, jgeo, "y", "x", ny, nx)
        return out, jnp.broadcast_to(fresh.astype(jnp.uint32), xs.shape)

    fn = jax.jit(jax.shard_map(exchange, mesh=mesh, in_specs=(P("y", "x"),),
                               out_specs=(P("y", "x"),) * 2, check_vma=False))
    out, fresh = (np.asarray(a).reshape(ny, geo.hw + 1, nx, geo.ext_w).transpose(0, 2, 1, 3)
                  .reshape(ny * nx, geo.hw + 1, geo.ext_w) for a in fn(g))
    np.testing.assert_array_equal(got, out[:, :geo.hw])
    np.testing.assert_array_equal(new > 0, fresh[:, 0, 0] == 1)


# -- the loop kernel's prologue and the standalone refresh -------------------


def prologue(f, p, grow, geo, grid, seed=0):
    """The two refreshes before the round loop as the loop kernel's prologue
    runs them, each tile one band: (FINAL, CANDIDATE, flag). Both planes are
    published from one snapshot, each into a garbage scratch of its own;
    after the barrier each tile ORs in its halo words of both; the flag is
    "some FINAL bit new, or some grow". Each plane's part is also the
    standalone ``halo_exchange``."""
    rng = np.random.default_rng(seed)
    mf, mp = Model(geo, grid, rng), Model(geo, grid, rng)
    f, p = f.copy(), p.copy()
    tiles = bands(geo.hw, geo.ext_w, geo.ext_w, 1)
    for t in range(mf.T):
        for band in tiles:
            mf.publish(f, t, *band)
            mp.publish(p, t, *band)
    new = 0
    for t in range(mf.T):
        for band in tiles:
            new += mf.apply(f, t, *band)
            mp.apply(p, t, *band)
    return f, p, int(new > 0 or bool(np.any(grow)))


def _two_exchanges(f, p, grow, geo, grid):
    """The port's two refreshes before the host loop (packed_halo.py's
    ``exchange(p)``, ``exchange(f, grow=, pending=)``)."""
    ft, pt = _to_torch(f), _to_torch(p)
    pending = torch.zeros(1, dtype=torch.int32)
    halo_exchange_plain(pt, grid, geo)
    halo_exchange_plain(ft, grid, geo, grow=torch.from_numpy(grow), pending=pending)
    return ft.numpy().view(U32), pt.numpy().view(U32), int(pending)


#: (frame, mesh): the meshes of the sharded paths; small tiles whose two
#: halo slots share a word (16 x 24 and 8 x 8 over (1, 2, 2)); the 66 x 1918
#: frame over (1, 2, 2), whose bottom strip and bottom halo slot start in one
#: word.
PROLOGUE_CASES = [
    ((64, 200), (1, 2, 1)), ((40, 260), (1, 1, 2)), ((96, 160), (1, 2, 2)), ((64, 96), (2, 2, 2)),
    ((160, 256), (1, 4, 2)), ((16, 24), (1, 2, 2)), ((8, 8), (1, 2, 2)), ((66, 1918), (1, 2, 2)),
]


def _state(frame, grid, seed):
    nb, ny, nx = grid
    geo = ps.make_geo(frame[0] // ny, frame[1] // nx, ny=ny, nx=nx)
    rng = np.random.default_rng(seed)
    shape = (nb * ny * nx, geo.hw, geo.ext_w)
    return geo, _random_planes(rng, shape, geo.ext_h), _random_planes(rng, shape, geo.ext_h)


@pytest.mark.parametrize("frame,grid", PROLOGUE_CASES)
def test_prologue_matches_two_exchanges(frame, grid):
    """Both planes and the flag equal the port's ``exchange_packed`` of
    CANDIDATE, then of FINAL with the flag; the flag with a tile growing,
    with none, and from a state the refresh already reached (nothing new:
    only growth sets it)."""
    geo, f, p = _state(frame, grid, sum(frame))
    T = f.shape[0]
    none, one = np.zeros(T, np.int32), np.eye(1, T, T - 1, dtype=np.int32)[0]
    for grow in (none, one):
        got_f, got_p, flag = prologue(f, p, grow, geo, grid)
        want_f, want_p, want_flag = _two_exchanges(f, p, grow, geo, grid)
        np.testing.assert_array_equal(got_f, want_f)
        np.testing.assert_array_equal(got_p, want_p)
        assert flag == want_flag
    assert prologue(f, p, none, geo, grid)[2] == int(
        not np.array_equal(got_f, f))
    again = prologue(got_f, got_p, none, geo, grid, seed=1)
    np.testing.assert_array_equal(again[0], got_f)
    np.testing.assert_array_equal(again[1], got_p)
    assert again[2] == 0
    assert prologue(got_f, got_p, one, geo, grid, seed=2)[2] == 1


@pytest.mark.parametrize("frame,grid", PROLOGUE_CASES)
def test_sharded_loop_at_budget_0_is_the_prologue(frame, grid):
    """A budget of 0 still refreshes both planes, as the reference's loop
    does before its ``while_loop``: ``sharded_loop_plain`` (and
    ``sharded_loop`` on CPU tensors) leave the prologue's planes, the flags
    as they were, and 0 rounds."""
    geo, f, p = _state(frame, grid, sum(frame))
    T = f.shape[0]
    flags = np.zeros((T, 2, 2), np.int32)
    flags[:, 0, 1] = np.arange(T) % 2
    want_f, want_p, _ = prologue(f, p, flags[:, 0, 1], geo, grid)
    for loop in (sharded_loop_plain, sharded_loop):
        ft, pt, flt = _to_torch(f), _to_torch(p), torch.from_numpy(flags.copy())
        rounds = loop(ft, pt, flt, grid, geo, max_rounds=0)
        assert int(rounds) == 0
        np.testing.assert_array_equal(ft.numpy().view(U32), want_f)
        np.testing.assert_array_equal(pt.numpy().view(U32), want_p)
        np.testing.assert_array_equal(flt.numpy(), flags)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("frame,grid", PROLOGUE_CASES)
def test_prologue_matches_jax(frame, grid):
    """The prologue against the JAX ``exchange_packed`` of CANDIDATE, then of
    FINAL, under ``shard_map`` on a (1, ny, nx) mesh of virtual devices, a
    call per frame of the batch (the exchange never crosses frames), the
    flag the JAX loop's (packed_halo.py:296-305): some FINAL bit new, or
    some tile still growing."""
    nb, ny, nx = grid
    geo, f, p = _state(frame, grid, sum(frame) + 3)
    jgeo = jph.make_geo(geo.h_loc, geo.w_loc, granule=False, ny=ny, nx=nx)
    mesh = jax_mesh(batch=1, rows=ny, cols=nx, devices=jax.devices()[: ny * nx])

    def exchange(xs):
        out, fresh = jph.exchange_packed(xs, jgeo, "y", "x", ny, nx)
        return out, jnp.broadcast_to(fresh.astype(jnp.uint32), xs.shape)

    fn = jax.jit(jax.shard_map(exchange, mesh=mesh, in_specs=(P("y", "x"),),
                               out_specs=(P("y", "x"),) * 2, check_vma=False))

    def jax_exchange(x):
        g = np.concatenate([x, np.zeros((ny * nx, 1, geo.ext_w), U32)], axis=1)  # the guard row
        g = g.reshape(ny, nx, geo.hw + 1, geo.ext_w).transpose(0, 2, 1, 3)
        out, fresh = (np.asarray(a).reshape(ny, geo.hw + 1, nx, geo.ext_w).transpose(0, 2, 1, 3)
                      .reshape(ny * nx, geo.hw + 1, geo.ext_w)
                      for a in fn(jnp.asarray(g.reshape(ny * (geo.hw + 1), nx * geo.ext_w))))
        return out[:, :geo.hw], bool((fresh[:, 0, 0] == 1).any())

    T, per = f.shape[0], ny * nx
    for grow in (np.zeros(T, np.int32), np.eye(1, T, 0, dtype=np.int32)[0]):
        got_f, got_p, flag = prologue(f, p, grow, geo, grid)
        new = False
        for b in range(nb):
            tiles = slice(b * per, (b + 1) * per)
            want_p, _ = jax_exchange(p[tiles])
            want_f, fresh = jax_exchange(f[tiles])
            np.testing.assert_array_equal(got_p[tiles], want_p)
            np.testing.assert_array_equal(got_f[tiles], want_f)
            new |= fresh
        assert flag == int(new or bool(grow.any()))
