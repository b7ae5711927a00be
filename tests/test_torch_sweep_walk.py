"""The threshold sweep's pack (``csrc/sweep.cu``) as a NumPy model: the
column walk of ``sweep_pack_all`` and the word-wise ``sweep_seed``, held to
the port's plain versions, and whole sweeps built on them (the rounds in
between from ``bitpack.converge_packed``) held to ``sweep_fused_plain`` and
to the JAX package's ``sweep_fused`` in interpret mode.

``sweep_pack_all``: thread (k, c) holds the 32 values of column c in word
row k, clamped at 0 (0 past H); for each slot s of the (2K,) bounds, staged
``SWEEP_CHUNK`` pairs at a time and clamped at 0, it appends the sign of
(hi - v) and of (lo - v) to two words, row 31 first (one funnel shift
each), and stores FINAL = the first and CANDIDATE = the second and not the
first. ``sweep_seed`` (slot i >= 1): when slot i - 1's clamped pair
dominates slot i's, slot i's FINAL words |= slot i - 1's. A sweep: the
pairs in ``sweep_order`` (with the seed) or as given (without), one pack of
every slot, then per slot its seed and its rounds, and each map unpacked to
its pair's original index.

Cases: seeded and cold sweeps; exact duplicates (after the clamp); negative
lows; K = 1, 2, 16 and 65; the 64 x 128 spiral cut off by the cap
(``tests/test_torch_sweep.py``'s finals); values and bounds at the ends of
int32, where a plain subtraction would overflow; more pairs than a staged
chunk.

Tolerance: 0. Packed words and edge maps are integers, and the contract is
byte equality, maps cut off by the cap included (with the same seeding).
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.io.sources import make_spiral_thresh
from cudacam_tpu.ops.pallas import hysteresis_fused as jhf
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda import hysteresis_fused as thf

torch.set_num_threads(2)

_SRC = Path(__file__).resolve().parents[1] / "cudacam_tpu_torch" / "csrc" / "sweep.cu"
#: Pairs staged in shared memory at a time, read from the kernel's source.
CHUNK = int(re.search(r"constexpr int SWEEP_CHUNK = (\d+);", _SRC.read_text()).group(1))
M32 = 0xFFFFFFFF


def model_pack_all(kg: np.ndarray, bounds: np.ndarray):
    """(H, W) int32 keep*g, (2K,) int32 bounds -> (K, ceil(H/32), W) int32
    FINAL and CANDIDATE planes, thread by thread (every thread at once)."""
    h, w = kg.shape
    hw, k = -(-h // 32), len(bounds) // 2
    v = np.zeros((hw * 32, w), np.int64)
    v[:h] = np.maximum(kg.astype(np.int64), 0)
    v = v.reshape(hw, 32, w)  # v[kr, j, c]: thread (kr, c)'s value j
    f = np.zeros((k, hw, w), np.int64)
    p = np.zeros((k, hw, w), np.int64)
    for s0 in range(0, k, CHUNK):  # the staged chunks
        sb = np.maximum(np.asarray(bounds, np.int64)[2 * s0:2 * min(k, s0 + CHUNK)], 0)
        for i in range(len(sb) // 2):
            lo, hi = sb[2 * i], sb[2 * i + 1]
            fw = np.zeros((hw, w), np.int64)
            gw = np.zeros((hw, w), np.int64)
            for j in range(31, -1, -1):
                d_hi, d_lo = hi - v[:, j], lo - v[:, j]
                # both operands in [0, 2^31): the difference is an int32
                assert (np.abs(d_hi) < 2**31).all() and (np.abs(d_lo) < 2**31).all()
                fw = ((fw << 1) | ((d_hi & M32) >> 31)) & M32  # __funnelshift_l(d, w, 1)
                gw = ((gw << 1) | ((d_lo & M32) >> 31)) & M32
            f[s0 + i], p[s0 + i] = fw, gw & ~fw & M32
    return f.astype(np.uint32).view(np.int32), p.astype(np.uint32).view(np.int32)


def model_seed(bounds: np.ndarray, slot: int, f: np.ndarray) -> None:
    b = np.maximum(np.asarray(bounds, np.int64), 0)
    if b[2 * slot - 2] >= b[2 * slot] and b[2 * slot - 1] >= b[2 * slot + 1]:
        f[slot] |= f[slot - 1]


def model_sweep(kg, bounds, *, monotone_seed, max_iters=100, dilate_steps=16, scan_after=10):
    """A whole sweep on the modelled packs, the rounds from ``bitpack``."""
    h, w = kg.shape
    k = len(bounds) // 2
    pairs = np.maximum(np.asarray(bounds, np.int64), 0).reshape(k, 2)
    order = np.lexsort((-pairs[:, 1], -pairs[:, 0])) if monotone_seed else np.arange(k)
    sb = np.asarray(bounds, np.int32).reshape(k, 2)[order].reshape(-1)
    f, p = model_pack_all(kg, sb)
    out = np.empty((k, h, w), np.uint8)
    for i in range(k):
        if monotone_seed and i:
            model_seed(sb, i, f)
        fc, _, _ = bitpack.converge_packed(torch.from_numpy(f[i]), torch.from_numpy(p[i]), h, w,
                                           dilate_steps, scan_after, max_iters)
        f[i] = fc.numpy()
        out[order[i]] = np.where(bitpack.unpack_mask(fc, h).numpy(), 255, 0)
    return out


def _bounds(rng, k, lo_min=-5, top=300):
    lows = rng.integers(lo_min, top, k)
    return np.stack([lows, lows + rng.integers(0, top // 2, k)], 1).reshape(-1).astype(np.int32)


@pytest.mark.parametrize("h,w", [(40, 70), (64, 128), (1, 1), (33, 5), (96, 33)])
@pytest.mark.parametrize("k", [1, 2, 16, 65, CHUNK + 3])
def test_pack_all_matches_plain(h, w, k):
    rng = np.random.default_rng(h * 131 + w + k)
    kg = rng.integers(-50, 350, (h, w)).astype(np.int32)
    bounds = _bounds(rng, k)
    bounds[:2 * min(k, 3)] = [20, 60, -3, 40, 20, 60][:2 * min(k, 3)]  # negative low, duplicate
    f, p = model_pack_all(kg, bounds)
    tf = torch.zeros((k, -(-h // 32), w), dtype=torch.int32)
    tp = torch.zeros_like(tf)
    thf.sweep_pack_all(torch.from_numpy(kg), torch.from_numpy(bounds), tf, tp)
    np.testing.assert_array_equal(f, tf.numpy())
    np.testing.assert_array_equal(p, tp.numpy())


def test_pack_all_at_the_ends_of_int32():
    """Values from -2^31 to 2^31 - 1 against bounds up to 2^31 - 1 (and below
    0): the clamp keeps every subtraction inside int32."""
    rng = np.random.default_rng(9)
    ends = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int64)
    kg = rng.choice(ends, (45, 37)).astype(np.int32)
    bounds = np.array([0, 2**31 - 1, 2**31 - 2, 2**31 - 1, -2**31, 0, -1, 2**31 - 2, 1, -2**31,
                       2**31 - 1, 2**31 - 1], np.int32)
    f, p = model_pack_all(kg, bounds)
    tf = torch.zeros((6, 2, 37), dtype=torch.int32)
    tp = torch.zeros_like(tf)
    thf.sweep_pack_all(torch.from_numpy(kg), torch.from_numpy(bounds), tf, tp)
    np.testing.assert_array_equal(f, tf.numpy())
    np.testing.assert_array_equal(p, tp.numpy())


def test_seed_matches_plain():
    rng = np.random.default_rng(4)
    bounds = np.int32([30, 90, 30, 90, 10, 95, 5, 40, -2, 40, 0, 41])
    f = rng.integers(-2**31, 2**31, (6, 3, 21), dtype=np.int64).astype(np.int32)
    for slot in range(1, 6):
        want, got = torch.from_numpy(f.copy()), f.copy()
        thf.sweep_seed(torch.from_numpy(bounds), slot, want)
        model_seed(bounds, slot, got)
        np.testing.assert_array_equal(got, want.numpy())
        assert (got[slot] != f[slot]).any() == (slot in (1, 3, 4))


@pytest.fixture(scope="module")
def spiral_kg():
    t = make_spiral_thresh(64, 128)
    return np.where(t == 255, 3, np.where(t == 128, 2, 0)).astype(np.int32)


def _all(kg, bounds, **kw):
    got = model_sweep(kg, np.int32(bounds), **kw)
    plain = thf.sweep_fused_plain(torch.from_numpy(kg), torch.from_numpy(np.int32(bounds)), **kw)
    jax_out = jhf.sweep_fused(jnp.asarray(kg), jnp.asarray(np.int32(bounds)), interpret=True, **kw)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_out))
    return got


@pytest.mark.parametrize("max_iters,scan_after,seeded,cold", [
    (4, 100, [5, 9, 13], [5, 5, 5]),            # phase 1 cut off
    (6, 2, [738, 1410, 2018], [738, 738, 738]),  # phase 2 cut off
])
@pytest.mark.parametrize("monotone_seed", [True, False])
def test_spiral_cut_off_by_the_cap(spiral_kg, max_iters, scan_after, seeded, cold, monotone_seed):
    got = _all(spiral_kg, [1, 2, 1, 2, 0, 2], max_iters=max_iters, dilate_steps=1,
               scan_after=scan_after, monotone_seed=monotone_seed)
    assert (got == 255).sum((1, 2)).tolist() == (seeded if monotone_seed else cold)


@pytest.mark.parametrize("k", [1, 2, 16, 65])
@pytest.mark.parametrize("monotone_seed", [True, False])
def test_sweeps_match_plain_and_pallas(k, monotone_seed):
    """Random pairs with negative lows and exact duplicates (after the
    clamp), converged and cut off by the cap, on a noisy 40 x 70 plane."""
    rng = np.random.default_rng(k)
    kg = rng.integers(0, 300, (40, 70)).astype(np.int32)
    bounds = _bounds(rng, k)
    if k >= 2:
        bounds[2:4] = bounds[0:2]  # an exact duplicate
    if k >= 16:
        bounds[4:8] = [-3, 120, 0, 120]  # the same pair after the clamp
    for kw in (dict(max_iters=100, dilate_steps=2, scan_after=3),
               dict(max_iters=5, dilate_steps=1, scan_after=2)):
        _all(kg, bounds, monotone_seed=monotone_seed, **kw)
