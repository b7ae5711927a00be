"""The port's two-kernel hysteresis (``pack_thresh`` + the round kernels +
``unpack``, CPU route: their plain versions) against the JAX package's fused
hysteresis Pallas kernel in interpret mode: ``hysteresis_fused`` on scene
threshold maps, on a spiral cut off by the cap (with the round count), with
candidates kept, and ``hysteresis_fused_nmsq`` on the keep*g plane.

Tolerance: 0. Edge maps, packed words and round counts are integers.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.io.sources import make_scene, make_spiral_thresh
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops.pallas import hysteresis_fused as jhf
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda import hysteresis_fused as thf
from cudacam_tpu_torch.ops.cuda.feedforward import NMSQ, ff_stages

torch.set_num_threads(2)

H, W = 64, 256


def _thresh(seed, lo=10, hi=40):
    cfg = CannyConfig(height=H, width=W)
    return np.array(xla_ops.canny_to_stage(
        jnp.asarray(make_scene(H, W, seed=seed)), jnp.int32(lo), jnp.int32(hi), cfg,
        CannyStage.THRESH))


@pytest.mark.parametrize("seed,scan_after", [(1, 10), (2, 1)])
def test_scene_threshold_maps(seed, scan_after):
    t = _thresh(seed)
    kw = dict(max_iters=100, dilate_steps=16, scan_after=scan_after)
    got, iters = thf.hysteresis_fused(torch.from_numpy(t), return_iters=True, **kw)
    want, jiters = jhf.hysteresis_fused(jnp.asarray(t), return_iters=True, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(iters) == int(jiters)


def test_spiral_cut_off_by_the_cap():
    """A spiral far from converged at max_iters=5: the truncated edge map and
    the round count are the JAX kernel's."""
    t = make_spiral_thresh(H, W)
    kw = dict(max_iters=5, dilate_steps=16, scan_after=2)
    got, iters = thf.hysteresis_fused(torch.from_numpy(t), return_iters=True, **kw)
    want, jiters = jhf.hysteresis_fused(jnp.asarray(t), return_iters=True, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(iters) == int(jiters) == 5
    f, p = bitpack.pack_pair(torch.from_numpy(t))
    assert bitpack.converge_packed(f, p, H, W, 16, 2, 5)[2]  # still growing at the cap


def test_keep_candidates():
    t = _thresh(3)
    got = thf.hysteresis_fused(torch.from_numpy(t), remove_candidates=False, scan_after=2)
    want = jhf.hysteresis_fused(jnp.asarray(t), remove_candidates=False, scan_after=2,
                                interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 128).any()


@pytest.mark.parametrize("lo,hi", [(10, 40), (-7, 25)])
def test_nmsq_mode(lo, hi):
    """keep*g plus comparable-domain bounds (clamped at 0 on both sides):
    the JAX nmsq kernel's edge map, and the u8 path's for the same pair."""
    fr = make_scene(H, W, seed=4)
    (kg,) = ff_stages(torch.from_numpy(fr), None, (NMSQ,))
    lo_c, hi_c = (np.int32(xla_ops.threshold_magnitude_bound(jnp.int32(t), 4, "l2")) - 1
                  for t in (lo, hi))
    got = thf.hysteresis_fused_nmsq(kg, int(lo_c), int(hi_c), scan_after=2)
    want = jhf.hysteresis_fused_nmsq(jnp.asarray(kg.numpy()), lo_c, hi_c, scan_after=2,
                                     interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if lo >= 0:
        t = _thresh(4, lo, hi)
        np.testing.assert_array_equal(
            got.numpy(), thf.hysteresis_fused(torch.from_numpy(t), scan_after=2).numpy())


def test_pack_thresh_modes():
    rng = np.random.default_rng(5)
    t = rng.choice(np.uint8([0, 128, 255, 7]), size=(37, 53))
    f, p = thf.pack_thresh(torch.from_numpy(t))
    ef, ep = bitpack.pack_pair(torch.from_numpy(t))
    assert torch.equal(f, ef) and torch.equal(p, ep)
    kg = torch.from_numpy(rng.integers(0, 500, (37, 53), dtype=np.int32))
    f, p = thf.pack_thresh(kg, torch.tensor([-4, 200], dtype=torch.int32))
    fin, cand = bitpack.unpack_mask(f, 37), bitpack.unpack_mask(p, 37)
    assert torch.equal(fin, kg > 200) and torch.equal(cand, (kg > 0) & (kg <= 200))
    with pytest.raises(ValueError):
        thf.pack_thresh(kg)  # an int32 plane needs bounds
    with pytest.raises(ValueError):
        thf.pack_thresh(torch.from_numpy(t), torch.tensor([1, 2], dtype=torch.int32))
