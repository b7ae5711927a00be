"""The column-split continuation (K11) on resident slices and over a batch.

``split_kernel`` (``csrc/hyst_rounds.cu``) keeps every slice of the frames
still growing in the blocks' shared memory for the whole launch, cut into
column bands of ``bw`` columns and ``ns`` stacked height segments. Between
seam rounds it does not extract the slices again: the bands that hold owned
columns within k of a seam publish them into the slice's seam records, one
grid barrier, and the bands that hold a slice's halo columns OVERWRITE them
with the neighbours' records; the change test is "the popcount of the owned
columns a band holds grew". The NumPy model below is that schedule, band by
band, with the published records starting as garbage (a word some band reads
but no band published shows up as a difference), over a batch of frames
whose seam loops advance together, each frame with its own budget count and
a mask that keeps the frames out of their loop from taking a round. The
inner rounds of a slice are ``bitpack.converge_packed`` from round 0, as in
the reference. On a crafted map the same model with an OR refresh gives
other bytes.

Held byte for byte to the port's ``converge_packed_split_plain`` and to the
JAX package's ``converge_packed_split`` (its Pallas saturate kernel in
interpret mode); the batched plain version to the JAX split frame by frame;
and ``CannyEngine(continuation='split')`` on a batch to the JAX engine frame
by frame. Tolerance 0: every value is a packed word or a flag, outputs cut
off by the budget included.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig as JaxConfig
from cudacam_tpu.engine import CannyEngine as JaxEngine
from cudacam_tpu.io.sources import make_scene, make_spiral_frame, make_spiral_thresh
from cudacam_tpu.ops.pallas.hysteresis_fused import converge_packed_split as jax_split
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
    converge_packed_split, converge_packed_split_batched, converge_packed_split_batched_plain,
    converge_packed_split_plain,
)
from cudacam_tpu_torch.state import config_from_jax, planes_to_jax, planes_to_numpy

U32 = np.uint32


def _popc(x: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(x, dtype=U32).view(np.uint8)).sum())


class SeamModel:
    """``split_kernel``'s resident seam schedule on (B, hw, w) uint32
    planes and (B, 2, 2) flags, slices cut into bands of ``bw`` columns and
    ``ns`` height segments."""

    def __init__(self, h, n_split, *, bw, ns, rng, dilate_steps, scan_after, max_iters, chunk,
                 refresh="overwrite"):
        self.h, self.n, self.bw, self.ns, self.rng = h, n_split, bw, ns, rng
        self.refresh = refresh
        self.kw = dict(dilate_steps=dilate_steps, scan_after=scan_after)
        self.cap, self.chunk = max_iters, chunk
        self.seam_rounds = []

    def bands(self, hw, sw):
        """(first row, rows, first column, columns) of every tile of a slice."""
        rows = [(s * hw // self.ns, (s + 1) * hw // self.ns) for s in range(self.ns)]
        return [(k0, k1 - k0, c0, min(self.bw, sw - c0))
                for k0, k1 in rows for c0 in range(0, sw, self.bw)]

    def run(self, f: np.ndarray, p: np.ndarray, flags: np.ndarray):
        nf, hw, w = f.shape
        n = self.n
        ws = w // n
        k = min(64, ws)
        sw = ws + 2 * k

        def cut(x, b, i):  # the load once: zero outside the frame
            out = np.zeros((hw, sw), U32)
            lo = i * ws - k
            a, z = max(lo, 0), min(lo + sw, w)
            out[:, a - lo:z - lo] = x[b, :, a:z]
            return out

        it = [int(v) for v in flags[:, 0, 0]]
        ch = [int(v != 0) for v in flags[:, 0, 1]]
        on = [bool(ch[b] and it[b] < self.cap) for b in range(nf)]
        sl = {(b, i): cut(f, b, i) for b in range(nf) if on[b] for i in range(n)}
        sp = {(b, i): cut(p, b, i) for b in range(nf) if on[b] for i in range(n)}
        tiles = self.bands(hw, sw)

        def owned(d):
            k0, hk, c0, cb = d
            return slice(k0, k0 + hk), slice(max(k - c0, 0) + c0, min(k + ws - c0, cb) + c0)

        ocnt = {(key, d): _popc(x[owned(d)]) for key, x in sl.items() for d in tiles}
        # Records [0]: the first k owned columns, [1]: the last k; garbage at first.
        pub = {key: self.rng.integers(0, 2**32, (2, hw, k), dtype=np.uint64).astype(U32)
               for key in sl}
        inner = self.chunk if self.chunk is not None else self.cap
        taken = [0] * nf
        while any(on):
            spent = [0] * nf
            for (b, i), x in sl.items():
                if not on[b]:
                    continue
                out, si, _ = bitpack.converge_packed(
                    torch.from_numpy(x.view(np.int32).copy()),
                    torch.from_numpy(sp[b, i].view(np.int32).copy()), self.h, sw,
                    max_iters=inner, **self.kw)
                sl[b, i] = out.numpy().view(U32).copy()
                spent[b] = max(spent[b], si)
            changed = [0] * nf
            for (b, i), x in sl.items():
                if not on[b]:
                    continue
                for d in tiles:  # the change test on owned columns, the records out
                    c = _popc(x[owned(d)])
                    if c != ocnt[(b, i), d]:
                        ocnt[(b, i), d] = c
                        changed[b] = 1
                    k0, hk, c0, cb = d
                    for r, lo in ((0, k), (1, ws)):
                        if (r == 0 and i == 0) or (r == 1 and i == n - 1):
                            continue
                        t0, t1 = max(lo - c0, 0), min(lo + k - c0, cb)
                        if t0 < t1:
                            pub[b, i][r, k0:k0 + hk, c0 + t0 - lo:c0 + t1 - lo] = \
                                x[k0:k0 + hk, c0 + t0:c0 + t1]
            for b in range(nf):
                if on[b]:
                    ch[b] = changed[b]
                    it[b] += spent[b] if self.chunk is not None else 1
                    on[b] = bool(ch[b] and it[b] < self.cap)
                    taken[b] += 1
            for (b, i), x in sl.items():
                if not on[b]:
                    continue
                for k0, hk, c0, cb in tiles:  # the refresh: overwrite the halo columns
                    for r, lo, nbr in ((0, 0, i - 1), (1, k + ws, i + 1)):
                        if not 0 <= nbr < n:
                            continue
                        t0, t1 = max(lo - c0, 0), min(lo + k - c0, cb)
                        if t0 < t1:
                            new = pub[b, nbr][1 - r, k0:k0 + hk, c0 + t0 - lo:c0 + t1 - lo]
                            if self.refresh == "or":
                                new = new | x[k0:k0 + hk, c0 + t0:c0 + t1]
                            x[k0:k0 + hk, c0 + t0:c0 + t1] = new
        out = f.copy()
        for (b, i), x in sl.items():  # write once: the owned columns
            out[b, :, i * ws:(i + 1) * ws] = x[:, k:k + ws]
        fl = flags.copy()
        fl[:, 1, 0], fl[:, 1, 1] = it, ch
        self.seam_rounds = taken
        return out, fl


def _planes(t: np.ndarray):
    """A uint8 threshold map -> the port's (hw, w) int32 F and P planes."""
    return bitpack.pack_pair(torch.from_numpy(t))


def _jax(f, p, flags0, h, n_split, **kw):
    """The JAX split on the port's planes: (F, growing)."""
    w = f.shape[-1]
    fg, pg = planes_to_jax(f, p)
    want, growing = jax_split(jnp.asarray(fg), jnp.asarray(pg), h, w, n_split,
                              it0=int(flags0[0][0]), interpret=True, **kw)
    want = np.asarray(want)
    hw = -(-h // 32)
    assert not want[hw:].any() and not want[:, w:].any()  # the guard ring stays zero
    return want[:hw, :w], bool(growing)


def _model(f, p, flags, h, n_split, bw, ns, seed=0, **kw):
    """The model on (B, hw, w) uint32 planes: (planes, flags, seam rounds a
    frame)."""
    m = SeamModel(h, n_split, bw=bw, ns=ns, rng=np.random.default_rng(seed), **kw)
    out, fl = m.run(f, p, flags)
    return out, fl, m.seam_rounds


def _random_map(h, w, seed, probs=(0.55, 0.4, 0.05)):
    rng = np.random.default_rng(seed)
    return rng.choice([0, 128, 255], size=(h, w), p=list(probs)).astype(np.uint8)


#: (map, n_split, it0, schedule): random fields and the truncated spiral,
#: chunked and unchunked, heights that are not multiples of 32.
CASES = [
    ("spiral 64x512", 2, 0, dict(dilate_steps=4, scan_after=2, max_iters=12, chunk=4)),
    ("spiral 64x512", 4, 3, dict(dilate_steps=4, scan_after=0, max_iters=20, chunk=8)),
    ("spiral 64x512", 2, 0, dict(dilate_steps=4, scan_after=2, max_iters=5, chunk=None)),
    ("spiral 70x384", 4, 2, dict(dilate_steps=3, scan_after=1, max_iters=14, chunk=3)),
    ("random 96x256", 2, 0, dict(dilate_steps=4, scan_after=2, max_iters=200, chunk=4)),
    ("random 45x264", 4, 1, dict(dilate_steps=2, scan_after=1, max_iters=60, chunk=2)),
    ("random 45x264", 2, 0, dict(dilate_steps=2, scan_after=1, max_iters=3, chunk=None)),
]


def _map(name: str) -> np.ndarray:
    kind, shape = name.split()
    h, w = (int(v) for v in shape.split("x"))
    return make_spiral_thresh(h, w) if kind == "spiral" else _random_map(h, w, seed=h + w)


@pytest.mark.parametrize("bw,ns", [(32, 1), (64, 2), (96, 3)])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_resident_model_equals_plain_and_jax(case, bw, ns):
    name, n_split, it0, kw = CASES[case]
    t = _map(name)
    h = t.shape[0]
    f, p = _planes(t)
    flags0 = np.array([[[it0, 1], [0, 0]]], np.int32)
    got, gfl, seams = _model(np.stack(planes_to_numpy(f)), np.stack(planes_to_numpy(p)), flags0,
                             h, n_split, bw, ns, seed=case, **kw)
    fp, flp = f.clone(), torch.tensor(flags0[0])
    converge_packed_split_plain(fp, p, flp, h, n_split, **kw)
    np.testing.assert_array_equal(got[0], planes_to_numpy(fp)[0])
    assert gfl[0].tolist() == flp.tolist()
    want, grow = _jax(f, p, flags0[0], h, n_split, **kw)
    np.testing.assert_array_equal(got[0], want)
    assert gfl[0, 1, 1] == int(grow)
    assert seams[0] >= 1


def test_resident_model_overwrites_the_halo():
    """The refresh must overwrite. A line of candidates runs left from a
    FINAL pixel 72 columns right of the seam (beyond what the left slice
    sees) across the seam, down, and back right across it. In the first seam
    round the right slice's scans grow the line into its halo, where the left
    slice, blind to the seed, grows nothing. A refresh that ORs the records
    in keeps those halo bits, so the second seam round's scans carry them
    back across the seam a seam round early: other bytes than the
    reference when the budget ends there."""
    h, w = 64, 256
    t = np.zeros((h, w), np.uint8)
    t[5, 100:200], t[5, 200] = 128, 255
    t[5:41, 100] = 128
    t[40, 100:181] = 128
    f, p = _planes(t)
    kw = dict(dilate_steps=1, scan_after=0, max_iters=4, chunk=2)
    fp, flp = f.clone(), torch.tensor([[0, 1], [0, 0]], dtype=torch.int32)
    converge_packed_split_plain(fp, p, flp, h, 2, **kw)
    want = planes_to_numpy(fp)[0]
    f0, p0 = np.stack(planes_to_numpy(f)), np.stack(planes_to_numpy(p))
    flags0 = np.array([[[0, 1], [0, 0]]], np.int32)
    got, gfl, _ = _model(f0, p0, flags0, h, 2, 64, 1, **kw)
    np.testing.assert_array_equal(got[0], want)
    assert gfl[0].tolist() == flp.tolist() == [[0, 1], [4, 1]]
    ored, _, _ = _model(f0, p0, flags0, h, 2, 64, 1, refresh="or", **kw)
    assert (ored[0] & ~want).any() and not (want & ~ored[0]).any()


def _batch():
    """Four frames of one batch, each with its own it0: a frame converged
    at phase 1, a spent budget, the cap-class spiral cut off by the cap, and
    a frame that converges after a few seam rounds."""
    h, w = 64, 256
    maps = [_random_map(h, w, 3), make_spiral_thresh(h, w), make_spiral_thresh(h, w),
            _random_map(h, w, 11, probs=(0.35, 0.62, 0.03))]
    planes = [_planes(t) for t in maps]
    # frame 0 at the fixed point phase 1 left it in
    f0, it0, still = bitpack.converge_packed(*planes[0], h, w, 3, 0, 1000)
    assert not still
    planes[0] = (f0, planes[0][1])
    f = torch.stack([x for x, _ in planes])
    p = torch.stack([x for _, x in planes])
    flags = torch.tensor([[[it0, 0], [9, 9]], [[30, 1], [0, 0]], [[2, 1], [0, 0]],
                          [[1, 1], [0, 0]]], dtype=torch.int32)
    return h, f, p, flags


BATCH_KW = dict(dilate_steps=3, scan_after=0, max_iters=30, chunk=4)


def test_batched_plain_equals_jax_frame_by_frame():
    h, f, p, flags = _batch()
    got, gfl = f.clone(), flags.clone()
    out, growing = converge_packed_split_batched_plain(got, p, gfl, h, 2, **BATCH_KW)
    assert out is got and growing.tolist() == gfl[:, 1, 1].tolist()
    for b in range(len(f)):
        want, grow = _jax(f[b], p[b], flags[b].tolist(), h, 2, **BATCH_KW)
        np.testing.assert_array_equal(planes_to_numpy(got[b])[0], want)
        assert int(gfl[b, 1, 1]) == int(grow)
    # the mix the batch must hold: converged at phase 1, spent, cut off, converged later
    assert gfl[0, 1].tolist() == [int(flags[0, 0, 0]), 0] and torch.equal(got[0], f[0])
    assert gfl[1].tolist() == [[30, 1], [30, 1]] and torch.equal(got[1], f[1])
    assert gfl[2, 1].tolist()[1] == 1 and int(gfl[2, 1, 0]) >= 30
    assert int(gfl[3, 1, 1]) == 0 and int(gfl[3, 1, 0]) > 1 + BATCH_KW["chunk"]
    # every frame as a call on that frame alone
    for b in range(len(f)):
        fb, flb = f[b].clone(), flags[b].clone()
        converge_packed_split(fb, p[b], flb, h, 2, **BATCH_KW)
        assert torch.equal(fb, got[b]) and torch.equal(flb, gfl[b])
    # the batched entry point takes the plain route on CPU tensors
    again, afl = f.clone(), flags.clone()
    converge_packed_split_batched(again, p, afl, h, 2, **BATCH_KW)
    assert torch.equal(again, got) and torch.equal(afl, gfl)


@pytest.mark.parametrize("n_split,bw,ns", [(2, 32, 1), (2, 64, 2), (4, 32, 2)])
def test_resident_model_on_the_batch(n_split, bw, ns):
    """The frames' seam loops advance together in the model, each with its
    own budget count and mask: every frame's bytes and flags equal the
    plain call on that frame alone."""
    h, f, p, flags = _batch()
    got, gfl, seams = _model(np.stack(planes_to_numpy(*f)), np.stack(planes_to_numpy(*p)),
                             flags.numpy(), h, n_split, bw, ns, seed=n_split + bw, **BATCH_KW)
    for b in range(len(f)):
        fb, flb = f[b].clone(), flags[b].clone()
        converge_packed_split_plain(fb, p[b], flb, h, n_split, **BATCH_KW)
        np.testing.assert_array_equal(got[b], planes_to_numpy(fb)[0])
        assert gfl[b].tolist() == flb.tolist()
    assert seams[0] == seams[1] == 0 and seams[2] >= 2 and seams[3] >= 2


def test_batched_split_checks():
    h, f, p, flags = _batch()
    with pytest.raises(ValueError):
        converge_packed_split_batched(f[0], p[0], flags[0], h, 2)  # one frame's planes
    with pytest.raises(ValueError):
        converge_packed_split_batched(f, p, flags[:, 0], h, 2)  # (B, 2) flags
    with pytest.raises(ValueError):
        converge_packed_split_batched(f, p, flags.clone(), h, 3)  # 256 % 3
    with pytest.raises(ValueError):
        converge_packed_split_batched(f, p, flags.clone(), h, 2, chunk=0)
    with pytest.raises(ValueError):
        converge_packed_split_batched_plain(f, p, flags.clone(), h, 2, max_iters=0)


@pytest.mark.parametrize("cap", [12, 300])
def test_engine_split_batch_equals_the_jax_engine_frame_by_frame(cap):
    """``CannyEngine(continuation='split', device='cpu')`` on a batch of the
    spiral (cut off by the cap at 12) and two scenes, against the JAX
    engine's ``cont='split'`` on each frame."""
    h, w = 64, 256
    jcfg = JaxConfig(height=h, width=w, backend="pallas", interpret=True, continuation="split",
                     hysteresis_scan_after=2, hysteresis_inner_steps=4, max_hysteresis_iters=cap)
    frames = np.stack([make_spiral_frame(h, w), make_scene(h, w, seed=1),
                       make_scene(h, w, seed=2)])
    got = CannyEngine(config_from_jax(jcfg), device="cpu").process(frames).numpy()
    jeng = JaxEngine(jcfg)
    for b, fr in enumerate(frames):
        np.testing.assert_array_equal(got[b], np.asarray(jeng.process(fr)))
    assert (got == 255).any()
