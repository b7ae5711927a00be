"""The port's bit-packed round schedule (cudacam_tpu_torch/ops/bitpack.py)
against the JAX package's ops/bitpack.py: packing, every shift primitive,
each round operator, and the round loop at truncating caps.

Tolerance: 0. Packed words, round counts and edge maps are integers; the
contract is bit equality, including outputs cut off by the round cap.
Inputs are made from a seed with numpy and handed to both packages.
"""
from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.io.sources import make_spiral_thresh
from cudacam_tpu.ops import bitpack as jbp
from cudacam_tpu_torch import state
from cudacam_tpu_torch.ops import bitpack as tbp

torch.set_num_threads(2)

#: tests/test_cap_golden.py: the 1080p spiral at cap 100, scan_after 12.
SPIRAL_1080P_CAP100_SHA = "61ca860520f82b7a43be20833dcc5858dd7e6d25770f37aa4d9ed3e991848417"
SPIRAL_1080P_CAP100_FINALS = 248514


def _rand_words(shape, seed):
    """uint32 words over the full range: bit 31 is set in about half."""
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _rand_thresh(h, w, seed, p_final=0.02, p_cand=0.3):
    u = np.random.default_rng(seed).random((h, w))
    return np.where(u < p_final, 255, np.where(u < p_final + p_cand, 128, 0)).astype(np.uint8)


def _as_words(x_u32: np.ndarray) -> torch.Tensor:
    return tbp.to_words(torch.from_numpy(x_u32.view(np.int32)))


def _u32(words: torch.Tensor) -> np.ndarray:
    return tbp.from_words(words).numpy().view(np.uint32)


@pytest.mark.parametrize("h,w", [(37, 53), (80, 256), (1, 1), (64, 96), (33, 7)])
def test_pack_roundtrip_and_layout(h, w):
    t = _rand_thresh(h, w, h * w)
    f, p = tbp.pack_pair(torch.from_numpy(t))
    assert f.dtype == torch.int32 and tuple(f.shape) == (-(-h // 32), w)
    jf, jp = jbp.pack_pair(jnp.asarray(t))
    np.testing.assert_array_equal(state.planes_to_numpy(f)[0], np.asarray(jf))
    np.testing.assert_array_equal(state.planes_to_numpy(p)[0], np.asarray(jp))
    np.testing.assert_array_equal(tbp.unpack_mask(f, h).numpy(), t == 255)
    np.testing.assert_array_equal(tbp.unpack_mask(p, h).numpy(), t == 128)


def test_words_roundtrip_keeps_bit31():
    x = np.array([[0, 1, 2**31, 2**32 - 1, 0x80000001]], np.uint32)
    words = _as_words(x)
    assert int(words.min()) >= 0 and int(words.max()) == 2**32 - 1
    np.testing.assert_array_equal(_u32(words), x)


@pytest.mark.parametrize("k", [0, 1, -1, 2, -3, 5, -5])
def test_shift_words_and_cols(k):
    x = _rand_words((5, 9), 1)
    np.testing.assert_array_equal(_u32(tbp._shift_words(_as_words(x), k)),
                                  np.asarray(jbp._shift_words(jnp.asarray(x), k)))
    np.testing.assert_array_equal(_u32(tbp._shift_cols(_as_words(x), k)),
                                  np.asarray(jbp._shift_cols(jnp.asarray(x), k)))


@pytest.mark.parametrize("s", [1, -1, 5, -5, 31, -31, 32, -32, 33, -33, 70, -70])
def test_shift_px(s):
    x = _rand_words((4, 11), 2)
    x[:, 0] = 0x80000000  # a set bit 31 must not smear into the rows below
    np.testing.assert_array_equal(_u32(tbp._shift_px(_as_words(x), s)),
                                  np.asarray(jbp._shift_px(jnp.asarray(x), s)))


@pytest.mark.parametrize("s", [1, -1])
def test_shift_px_inexact(s):
    x = _rand_words((3, 8), 3)
    x[:, 0] = 0x80000000
    np.testing.assert_array_equal(_u32(tbp._shift_px_inexact(_as_words(x), s)),
                                  np.asarray(jbp._shift_px_inexact(jnp.asarray(x), s)))


@pytest.mark.parametrize("h,w", [(64, 96), (37, 53), (1, 40)])
@pytest.mark.parametrize("dilate_steps", [1, 3, 16])
def test_round_operators(h, w, dilate_steps):
    """One ``dilates`` and one ``scans`` on the same planes, and their
    composition (a phase-2 round), bit-equal to the JAX operators."""
    t = _rand_thresh(h, w, 7, p_final=0.01, p_cand=0.45)
    f, p = tbp.pack_pair(torch.from_numpy(t))
    jf, jp = jbp.pack_pair(jnp.asarray(t))
    dil, scan = tbp._make_ops(h, w, dilate_steps)
    jdil, jscan = jbp._make_ops(h, w, dilate_steps)
    fw, pw = tbp.to_words(f), tbp.to_words(p)
    np.testing.assert_array_equal(_u32(dil(fw, pw)), np.asarray(jdil(jf, jp)))
    np.testing.assert_array_equal(_u32(scan(fw, pw)), np.asarray(jscan(jf, jp)))
    np.testing.assert_array_equal(_u32(scan(dil(fw, pw), pw)), np.asarray(jscan(jdil(jf, jp), jp)))


@pytest.mark.parametrize("scan_after", [1, 2])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 4])
def test_converge_at_truncating_caps(scan_after, max_iters):
    """Caps that cut the spiral off mid-propagation: same planes, same round
    count, same still-growing flag as the JAX loop."""
    h, w = 64, 96
    t = make_spiral_thresh(h, w)
    f, p = tbp.pack_pair(torch.from_numpy(t))
    got, it, growing = tbp.converge_packed(f, p, h, w, dilate_steps=4,
                                           scan_after=scan_after, max_iters=max_iters)
    jf, jp = jbp.pack_pair(jnp.asarray(t))
    want, jit_, jgrow = jbp.converge_packed(jf, jp, h, w, dilate_steps=4,
                                            scan_after=scan_after, max_iters=max_iters)
    np.testing.assert_array_equal(state.planes_to_numpy(got)[0], np.asarray(want))
    assert (it, growing) == (int(jit_), bool(jgrow))
    assert growing  # the cap really truncated


def test_converge_to_fixed_point_matches_jax():
    h, w = 64, 96
    t = make_spiral_thresh(h, w)
    out = tbp.hysteresis_packed(torch.from_numpy(t), max_iters=400, dilate_steps=16,
                                scan_after=2).numpy()
    want = jbp.hysteresis_packed(jnp.asarray(t), max_iters=400, dilate_steps=16, scan_after=2)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_spiral_1080p_cap100_golden():
    t = torch.from_numpy(make_spiral_thresh(1080, 1920))
    f, p = tbp.pack_pair(t)
    ff, it, growing = tbp.converge_packed(f, p, 1080, 1920, dilate_steps=16,
                                          scan_after=12, max_iters=100)
    assert (it, growing) == (100, True)
    out = np.where(tbp.unpack_mask(ff, 1080).numpy(), 255, 0).astype(np.uint8)
    assert int((out == 255).sum()) == SPIRAL_1080P_CAP100_FINALS
    assert hashlib.sha256(out.tobytes()).hexdigest() == SPIRAL_1080P_CAP100_SHA
