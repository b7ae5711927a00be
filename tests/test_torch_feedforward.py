"""The port's feed-forward stage kernel ``ff_stages`` (CPU route, its plain
version) against the JAX package's feed-forward Pallas kernel in interpret
mode: ``feed_forward_all_stages`` on planar BGR (five outputs) and on mono
(four), ``feed_forward_to_stage`` per stage, and ``feed_forward_nmsq``.

Tolerance: 0. Every output is an integer buffer; the contract is byte
equality. Inputs are made from a seed with numpy and handed to both.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyStage
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops.pallas import feedforward as jff
from cudacam_tpu_torch.ops.cuda.feedforward import FF_STAGES, NMSQ, ff_stages

torch.set_num_threads(2)

THR = torch.tensor([10, 40], dtype=torch.int32)
CONFIGS = [
    dict(),
    dict(kernel_size=3, norm="l1"),
    dict(kernel_size=7, parity="opencv", grad_coeff=2),
]


def _jax(fn, x, kw, **extra):
    return fn(jnp.asarray(x), jnp.int32(10), jnp.int32(40), interpret=True, **kw, **extra)


def _assert_equal(got, want, stages):
    assert len(got) == len(want) == len(stages)
    for s, g, e in zip(stages, got, want):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype, s
        np.testing.assert_array_equal(g.numpy(), e, err_msg=str(s))


@pytest.mark.parametrize("kw", CONFIGS)
def test_all_stages_planar_bgr(kw):
    """32x128 BGR with block_h=16: two slabs, five outputs from one pass."""
    fr = make_scene(32, 128, seed=1)
    got = ff_stages(torch.from_numpy(fr), THR, FF_STAGES, **kw)
    want = _jax(jff.feed_forward_all_stages, np.transpose(fr, (2, 0, 1)), kw, block_h=16)
    _assert_equal(got, want, FF_STAGES)


@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_all_stages_mono(kw):
    mono = make_scene(32, 64, seed=2)[..., 1].copy()
    got = ff_stages(torch.from_numpy(mono), THR, FF_STAGES[1:], **kw)
    want = _jax(jff.feed_forward_all_stages, mono, kw)
    _assert_equal(got, want, FF_STAGES[1:])


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("stage", FF_STAGES[1:])
def test_single_stage(stage, kw):
    """Each stage alone (the chain stops at it), on an off-granule mono
    frame."""
    mono = make_scene(37, 53, seed=3)[..., 2].copy()
    (got,) = ff_stages(torch.from_numpy(mono), THR, (stage,), **kw)
    want = _jax(jff.feed_forward_to_stage, mono, kw, out_stage=stage)
    _assert_equal((got,), (want,), (stage,))


def test_mono_stage_of_bgr():
    """MONO comes from the kernel on a BGR frame, equal to xla_ops.rgb2mono."""
    fr = make_scene(37, 53, seed=4)
    (got,) = ff_stages(torch.from_numpy(fr), None, (CannyStage.MONO,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla_ops.rgb2mono(jnp.asarray(fr))))


@pytest.mark.parametrize("kw", [dict(), dict(kernel_size=3, norm="l1"), dict(kernel_size=7)])
def test_nmsq(kw):
    """The threshold-free int32 keep*g plane (K4's mode), from mono and from
    planar BGR."""
    fr = make_scene(32, 128, seed=5)
    mono = np.asarray(xla_ops.rgb2mono(jnp.asarray(fr)))
    (got,) = ff_stages(torch.from_numpy(fr), None, (NMSQ,), **kw)
    assert got.dtype == torch.int32
    for x in (mono, np.transpose(fr, (2, 0, 1))):
        want = jff.feed_forward_nmsq(jnp.asarray(x), interpret=True, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stage_sets_are_checked():
    fr = torch.from_numpy(make_scene(37, 53, seed=6))
    for bad in [(), (CannyStage.NMS, CannyStage.NMS), (NMSQ, CannyStage.NMS),
                (CannyStage.HYSTER,)]:
        with pytest.raises(ValueError):
            ff_stages(fr, THR, bad)
    with pytest.raises(ValueError, match="THRESH needs thresholds"):
        ff_stages(fr, None, (CannyStage.THRESH,))
    # outputs come back in the order asked
    nms, blur = ff_stages(fr, THR, (CannyStage.NMS, CannyStage.GAUSSIAN))
    blur2, nms2 = ff_stages(fr, THR, (CannyStage.GAUSSIAN, CannyStage.NMS))
    assert torch.equal(nms, nms2) and torch.equal(blur, blur2)
