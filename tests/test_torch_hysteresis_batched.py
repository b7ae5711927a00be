"""The port's batched hysteresis (``hysteresis_fused_batched``: ``pack_thresh``
over a (g, H, W) stack, the batched round kernels and ``unpack``; CPU route:
their plain versions) against the JAX package's ``hysteresis_fused_batched``
in interpret mode (its stacked sections, one Pallas launch), each map against
its solo run through the JAX ``bitpack`` XLA path, the batched pack against
the per-frame pack, and the entry's checks.

Sizes are small (32x128 and 37x64 maps) so that the interpret-mode runs
take seconds. Tolerance: 0. Edge maps and packed words are integers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu.io.sources import make_spiral_thresh
from cudacam_tpu.ops.bitpack import hysteresis_packed
from cudacam_tpu.ops.pallas import hysteresis_fused as jhf
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops import cuda as kernels
from cudacam_tpu_torch.ops.cuda import hysteresis_fused as thf

torch.set_num_threads(2)

_solo = jax.jit(hysteresis_packed, static_argnames=("max_iters", "dilate_steps", "scan_after"))

KW = dict(dilate_steps=4, scan_after=2)


def _random_map(h, w, seed, p=(0.6, 0.3, 0.1)):
    """A fast map: random FINAL / CANDIDATE pixels, converged in a few rounds."""
    rng = np.random.default_rng(seed)
    return rng.choice([0, 128, 255], size=(h, w), p=list(p)).astype(np.uint8)


def _stack(h, w, g):
    """g maps of mixed convergence depths: fast random maps, sparse maps, and
    the spiral (a single long chain) second, so that a cap cuts it off while
    the others converge."""
    maps = [_random_map(h, w, 11), make_spiral_thresh(h, w)]
    maps += [_random_map(h, w, 20 + i, p=(0.9, 0.08, 0.02)) for i in range(g - 2)]
    return np.stack(maps[:g])


@pytest.mark.parametrize("max_iters", [2, 5, 100])
def test_matches_the_jax_batched_entry(max_iters):
    """A fast section and the spiral: byte for byte the JAX stacked-section
    kernel's output, the spiral cut off at caps 2 and 5."""
    t = _stack(32, 128, 2)
    kw = dict(max_iters=max_iters, **KW)
    got = thf.hysteresis_fused_batched(torch.from_numpy(t), **kw)
    want = np.asarray(jhf.hysteresis_fused_batched(jnp.asarray(t), interpret=True, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    f, p = bitpack.pack_pair(torch.from_numpy(t[1]))
    growing = bitpack.converge_packed(f, p, 32, 128, KW["dilate_steps"], KW["scan_after"],
                                      max_iters)[2]
    assert bool(growing) == (max_iters < 100)  # the cap cuts the spiral off below 100


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("h,w", [(32, 128), (37, 64)])
@pytest.mark.parametrize("max_iters", [2, 100])
def test_each_map_equals_its_solo_run(g, h, w, max_iters):
    """Each map of the stack equals the JAX ``bitpack`` XLA path on it
    alone, at H % 32 == 0 and != 0, converged and cut off; the plain
    batched version says the same."""
    t = _stack(h, w, g)
    kw = dict(max_iters=max_iters, **KW)
    got = thf.hysteresis_fused_batched(torch.from_numpy(t), **kw)
    assert got.shape == (g, h, w) and got.dtype == torch.uint8
    assert torch.equal(got, thf.hysteresis_fused_batched_plain(torch.from_numpy(t), **kw))
    for i in range(g):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(_solo(jnp.asarray(t[i]), **kw)))


def test_a_batch_of_one_equals_the_one_map_call():
    t = make_spiral_thresh(37, 64)
    kw = dict(max_iters=5, **KW)
    got = thf.hysteresis_fused_batched(torch.from_numpy(t)[None], **kw)
    assert torch.equal(got[0], thf.hysteresis_fused(torch.from_numpy(t), **kw))


def test_exported_from_ops_cuda():
    assert kernels.hysteresis_fused_batched is thf.hysteresis_fused_batched
    assert kernels.hysteresis_fused_batched_plain is thf.hysteresis_fused_batched_plain


@pytest.mark.parametrize("h,w", [(32, 128), (37, 64), (1, 5), (70, 33)])
def test_batched_pack_equals_the_per_frame_pack(h, w):
    """(g, H, W) maps -> (g, ceil(H/32), W) planes equal to each map's own
    pack, through the wrapper and the plain version; bits past h stay 0."""
    t = torch.from_numpy(np.stack([_random_map(h, w, s) for s in range(3)]))
    for fn in (thf.pack_thresh, thf.pack_thresh_plain):
        f, p = fn(t)
        assert f.shape == p.shape == (3, -(-h // 32), w) and f.dtype == torch.int32
        for i in range(3):
            fi, pi = thf.pack_thresh(t[i])
            assert torch.equal(f[i], fi) and torch.equal(p[i], pi)
        if h % 32:
            pad = ~((1 << (h % 32)) - 1)
            assert not (f[:, -1] & pad).any() and not (p[:, -1] & pad).any()


@pytest.mark.parametrize("bad", [
    torch.zeros((32, 64), dtype=torch.uint8),          # one map
    torch.zeros((2, 32, 64), dtype=torch.int32),       # not uint8
    torch.zeros((2, 1, 32, 64), dtype=torch.uint8),    # 4-d
    torch.zeros((0, 32, 64), dtype=torch.uint8),       # empty
])
def test_batched_entry_checks(bad):
    with pytest.raises(ValueError, match="stack of threshold maps"):
        thf.hysteresis_fused_batched(bad)
    with pytest.raises(ValueError, match="stack of threshold maps"):
        thf.hysteresis_fused_batched_plain(bad)


def test_one_map_entries_refuse_a_stack():
    """The one-map entries keep their (H, W) checks; no batched nmsq mode."""
    stack = torch.zeros((2, 32, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\(H, W\) uint8 threshold map"):
        thf.hysteresis_fused(stack)
    kg = torch.zeros((2, 32, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(H, W\) int32 keep\*g plane"):
        thf.pack_thresh(kg, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(H, W\) int32 keep\*g plane"):
        thf.hysteresis_fused_nmsq(kg, 1, 2)
