"""``process_all`` on a batch (one ``ff_stages`` pass over the frames, the
float planes over (B, H, W), ``hysteresis_fused_batched``; CPU route: the
plain versions) against the JAX engine's ``process_all`` on the same batch
and against the port's per-frame calls.

Tolerance: 0 for every integer buffer; ``grad`` and ``slope`` within 1e-6
relative against the JAX engine (sqrt and atan2 round on their own in torch
and XLA), exact against the port's own per-frame calls (the same torch ops).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig
from cudacam_tpu.engine import CannyEngine as JaxEngine
from cudacam_tpu.io.sources import make_scene, make_spiral_frame
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.state import config_from_jax

torch.set_num_threads(2)

H, W = 48, 64


def _batch(n, channels):
    frames = [make_scene(H, W, seed=10 + i) for i in range(n - 1)] + [make_spiral_frame(H, W)]
    batch = np.stack(frames)
    return batch if channels == 3 else batch[..., 1].copy()


def _cfg(channels, max_iters=100):
    return CannyConfig(height=H, width=W, channels=channels, backend="xla",
                       hysteresis_scan_after=2, max_hysteresis_iters=max_iters)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("max_iters", [3, 100])
def test_batch_matches_jax_engine_and_per_frame_calls(n, channels, max_iters):
    """Every key of a batch's ``process_all``: the JAX engine's on the same
    batch, and each frame's own call; at cap 3 the spiral frame is cut off."""
    cfg = _cfg(channels, max_iters)
    batch = _batch(n, channels)
    eng = CannyEngine(config_from_jax(cfg), device="cpu")
    got = eng.process_all(batch)
    want = JaxEngine(cfg).process_all(batch)
    assert got.keys() == want.keys()
    for k, e in want.items():
        g, e = got[k].numpy(), np.asarray(e)
        assert g.dtype == e.dtype and g.shape == e.shape == (n, H, W), k
        if k in ("grad", "slope"):
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, e, err_msg=k)
    for i in range(n):
        one = eng.process_all(batch[i])
        for k in one:
            assert torch.equal(got[k][i], one[k]), (i, k)


@pytest.mark.parametrize("shape", [(48, 64), (3, 48, 64), (37, 53)])
def test_conv_over_the_last_two_dims(shape):
    """The stencil helper the float planes use works on a frame or a stack
    of frames: each frame of a stack equals its own correlation."""
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8))
    sx, sy = torch_ops.sobel_sums(x)
    assert sx.shape == sy.shape == x.shape and sx.dtype == torch.int32
    if x.ndim == 3:
        for i in range(x.shape[0]):
            fx, fy = torch_ops.sobel_sums(x[i])
            assert torch.equal(sx[i], fx) and torch.equal(sy[i], fy)
