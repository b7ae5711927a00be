"""The legacy row-sweep hysteresis (K12): the port's plain version against the
JAX package's ``hysteresis_pallas`` in interpret mode for the same explicit
``block_h``, converged and cut off (by ``max_iters`` and by
``max_local_iters``), against the oracle's BFS, and against the port's fused
hysteresis. Tolerance 0: the maps are uint8 classes."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.io.sources import make_scene, make_spiral_thresh
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops.pallas import hysteresis_pallas
from cudacam_tpu_torch.ops import cuda as kernels
from cudacam_tpu_torch.ops.cuda.hysteresis import (
    DEFAULT_BLOCK_H, hysteresis_sweeps, hysteresis_sweeps_plain,
)
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import hysteresis_fused


def _random_map(h, w, seed, p_final=0.05):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 128, 255], np.uint8), size=(h, w),
                      p=[0.5, 0.5 - p_final, p_final])


def _scene_map(h, w, seed):
    f = make_scene(h, w, seed=seed)
    mono = oracle.rgb2mono(f)
    sx, sy = oracle.sobel_sums(oracle.gaussian_blur(mono, 5))
    keep = oracle.nms_keep_mask(sx, sy)
    nms = np.where(keep, oracle.nms_magnitude_u8(sx, sy), 0).astype(np.uint8)
    return oracle.double_threshold(nms, 10, 40)


def _jax(t, **kw):
    return np.asarray(hysteresis_pallas(jnp.asarray(t), interpret=True, **kw))


@pytest.mark.parametrize("block_h", [8, 16, 24])
@pytest.mark.parametrize("remove_candidates", [True, False])
def test_matches_pallas_converged_and_cut_off(block_h, remove_candidates):
    t = _random_map(40, 96, 0)
    for max_iters, max_local in ((100, 4096), (1, 4096), (100, 2), (1, 1)):
        kw = dict(max_iters=max_iters, remove_candidates=remove_candidates, block_h=block_h,
                  max_local_iters=max_local)
        got = hysteresis_sweeps(torch.from_numpy(t), **kw).numpy()
        np.testing.assert_array_equal(got, _jax(t, **kw), err_msg=str(kw))


@pytest.mark.parametrize("max_iters,max_local,finals", [(100, 4096, 4097), (2, 4096, 875),
                                                        (3, 16, 97)])
def test_spiral_cut_off_is_the_pallas_bytes(max_iters, max_local, finals):
    t = make_spiral_thresh(64, 128)
    kw = dict(max_iters=max_iters, block_h=16, max_local_iters=max_local)
    got = hysteresis_sweeps(torch.from_numpy(t), **kw).numpy()
    np.testing.assert_array_equal(got, _jax(t, **kw))
    assert int((got == 255).sum()) == finals


@pytest.mark.parametrize("h,w,seed", [(40, 96, 1), (37, 53, 2), (64, 128, 3), (1, 1, 4), (9, 300, 5)])
def test_converged_is_the_oracle_bfs_for_any_block_h(h, w, seed):
    t = _random_map(h, w, seed) if seed % 2 else _scene_map(h, w, seed) if min(h, w) > 8 \
        else _random_map(h, w, seed)
    want = oracle.hysteresis(t)
    for block_h in (None, 8, 16, 40, 1000):
        got = hysteresis_sweeps(torch.from_numpy(t), block_h=block_h)
        np.testing.assert_array_equal(got.numpy(), want)
    fused = hysteresis_fused(torch.from_numpy(t), max_iters=10000)
    np.testing.assert_array_equal(fused.numpy(), want)  # the differential check


def test_remove_candidates_keeps_or_drops_the_unreached():
    t = _random_map(40, 96, 7, p_final=0.01)
    kept = hysteresis_sweeps(torch.from_numpy(t), remove_candidates=False).numpy()
    dropped = hysteresis_sweeps(torch.from_numpy(t)).numpy()
    assert set(np.unique(dropped)) <= {0, 255} and (kept == 128).any()
    np.testing.assert_array_equal(kept == 255, dropped == 255)
    np.testing.assert_array_equal(kept[kept != 255], t[kept != 255])
    np.testing.assert_array_equal(kept, _jax(t, remove_candidates=False, block_h=DEFAULT_BLOCK_H))


def test_info_counts_sweeps_and_default_block_h():
    t = torch.from_numpy(make_spiral_thresh(64, 128))
    out, info = hysteresis_sweeps(t, max_iters=2, return_info=True)
    sweeps, changed, steps = info.tolist()
    assert (sweeps, changed) == (4, 1) and steps > 0  # cut off after 2 * max_iters sweeps
    assert torch.equal(out, hysteresis_sweeps_plain(t, max_iters=2, block_h=DEFAULT_BLOCK_H))
    _, info = hysteresis_sweeps(t, return_info=True)
    assert info[1] == 0 and info[0] < 200  # converged: the last sweep changed nothing
    _, info = hysteresis_sweeps(t, max_iters=0, return_info=True)
    assert info[0] == 1  # one sweep at least, as in the JAX package
    assert kernels.hysteresis_sweeps is hysteresis_sweeps  # the public op


@pytest.mark.parametrize("bad", [
    dict(thresh=torch.zeros((4, 4), dtype=torch.int32)),
    dict(thresh=torch.zeros((2, 4, 4), dtype=torch.uint8)),
    dict(thresh=torch.zeros((0, 4), dtype=torch.uint8)),
    dict(max_iters=-1), dict(max_local_iters=-1), dict(block_h=0),
])
def test_bad_arguments_raise(bad):
    kw = dict(dict(thresh=torch.zeros((4, 4), dtype=torch.uint8)), **bad)
    with pytest.raises(ValueError):
        hysteresis_sweeps(**kw)


@pytest.mark.parametrize("h,w,block_h", [
    (45, 1, 1), (45, 31, 15), (37, 33, 16), (45, 63, 17), (45, 65, 16), (101, 33, 48),
    (133, 31, 64), (229, 17, 112), (261, 9, 128), (8, 65, 1),
])
def test_odd_widths_and_block_heights_are_the_pallas_bytes(h, w, block_h):
    """The shapes of the kernel's card cases (widths across a thread's and a
    warp's share of columns, windows of 1-5 words a column, heights no
    multiple of ``block_h``): the plain version against
    ``hysteresis_pallas(interpret=True)``, converged and cut off by either
    cap, with and without ``remove_candidates``."""
    t = _random_map(h, w, h * w + block_h)
    for max_iters, max_local, rc in ((100, 4096, True), (1, 4096, False), (100, 1, True),
                                     (0, 3, False), (3, 0, True)):
        kw = dict(max_iters=max_iters, remove_candidates=rc, block_h=block_h,
                  max_local_iters=max_local)
        got = hysteresis_sweeps(torch.from_numpy(t), **kw).numpy()
        np.testing.assert_array_equal(got, _jax(t, **kw), err_msg=str(kw))
