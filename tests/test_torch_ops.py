"""The port's plain stage ops (cudacam_tpu_torch/ops/torch_ops.py) against
the JAX package's xla_ops and the NumPy oracle.

Tolerance: 0. Every output is integer; the contract is byte equality
(CLAUDE.md "Bit-exactness across backends"). Inputs are made from a seed
with numpy and handed to all three implementations.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops import xla_ops
from cudacam_tpu_torch.ops import torch_ops

torch.set_num_threads(2)

SHAPES = [(80, 256), (37, 53), (1, 1), (2, 5)]


def _frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    if min(h, w) < 8:  # make_scene's shapes need room; tiny frames are noise
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return make_scene(h, w, seed=seed)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _i32(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def _sobel(h, w, seed=0, ks=5):
    blur = oracle.gaussian_blur(oracle.rgb2mono(_frame(h, w, seed)), ks)
    sx, sy = oracle.sobel_sums(blur)
    return sx.astype(np.int32), sy.astype(np.int32)


@pytest.mark.parametrize("h,w", SHAPES)
def test_rgb2mono(h, w):
    fr = _frame(h, w, 1)
    want = oracle.rgb2mono(fr)
    np.testing.assert_array_equal(torch_ops.rgb2mono(_t(fr)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(xla_ops.rgb2mono(jnp.asarray(fr))), want)
    np.testing.assert_array_equal(torch_ops.rgb2mono(_t(want)).numpy(), want)  # mono passes


@pytest.mark.parametrize("ks", [3, 5, 7])
@pytest.mark.parametrize("h,w", SHAPES)
def test_gaussian_blur(ks, h, w):
    mono = oracle.rgb2mono(_frame(h, w, 2))
    want = oracle.gaussian_blur(mono, ks)
    np.testing.assert_array_equal(torch_ops.gaussian_blur(_t(mono), ks).numpy(), want)
    np.testing.assert_array_equal(np.asarray(xla_ops.gaussian_blur(jnp.asarray(mono), ks)), want)


def test_gaussian_blur_saturated():
    mono = np.full((9, 11), 255, np.uint8)  # the largest tap sums
    for ks in (3, 5, 7):
        np.testing.assert_array_equal(
            torch_ops.gaussian_blur(_t(mono), ks).numpy(), oracle.gaussian_blur(mono, ks)
        )


@pytest.mark.parametrize("h,w", SHAPES)
def test_sobel_sums(h, w):
    blur = oracle.gaussian_blur(oracle.rgb2mono(_frame(h, w, 3)), 5)
    sx, sy = torch_ops.sobel_sums(_t(blur))
    ox, oy = oracle.sobel_sums(blur)
    np.testing.assert_array_equal(sx.numpy(), ox)
    np.testing.assert_array_equal(sy.numpy(), oy)


def test_exact_isqrt_i32():
    rng = np.random.default_rng(4)
    top = 2 * 1020 * 1020
    s = np.arange(0, 1444, dtype=np.int64)
    m = np.concatenate([s * s, s * s - 1, s * s + 1, rng.integers(0, top + 1, 4000)])
    m = np.clip(m, 0, top).astype(np.int32)
    got = torch_ops.exact_isqrt_i32(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(xla_ops.exact_isqrt_i32(jnp.asarray(m))))
    np.testing.assert_array_equal(got, oracle._exact_isqrt(m.astype(np.int64)))


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_nms_keep_mask(norm, h, w):
    sx, sy = _sobel(h, w, 5)
    got = torch_ops.nms_keep_mask(_t(sx), _t(sy), norm).numpy()
    np.testing.assert_array_equal(got, oracle.nms_keep_mask(sx.astype(np.int64), sy.astype(np.int64), norm))
    np.testing.assert_array_equal(got, np.asarray(xla_ops.nms_keep_mask(jnp.asarray(sx), jnp.asarray(sy), norm)))


@pytest.mark.parametrize("coeff", [1, 2, 4, 8])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_nms_magnitude_u8(coeff, norm):
    sx, sy = _sobel(37, 53, 6)
    got = torch_ops.nms_magnitude_u8(_t(sx), _t(sy), coeff, norm).numpy()
    np.testing.assert_array_equal(got, oracle.nms_magnitude_u8(sx.astype(np.int64), sy.astype(np.int64), coeff, norm))
    np.testing.assert_array_equal(
        torch_ops.non_max_suppression(_t(sx), _t(sy), coeff, norm).numpy(),
        oracle.non_max_suppression(sx.astype(np.int64), sy.astype(np.int64), coeff, norm),
    )


@pytest.mark.parametrize("coeff", [1, 2, 4, 8])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_threshold_magnitude_bound(coeff, norm):
    t = np.arange(-3, 300, dtype=np.int32)
    got = torch_ops.threshold_magnitude_bound(_t(t), coeff, norm).numpy()
    want = np.asarray(xla_ops.threshold_magnitude_bound(jnp.asarray(t), coeff, norm))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 0), (10, 40), (254, 254), (255, 255), (0, 255)])
def test_double_threshold(lo, hi):
    nms = np.random.default_rng(7).integers(0, 256, (37, 53), dtype=np.uint8)
    got = torch_ops.double_threshold(_t(nms), _i32(lo), _i32(hi)).numpy()
    np.testing.assert_array_equal(got, oracle.double_threshold(nms, lo, hi))


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("lo,hi", [(0, 0), (30, 90), (1443, 2048)])
def test_double_threshold_opencv(norm, lo, hi):
    sx, sy = _sobel(37, 53, 8)
    keep = oracle.nms_keep_mask(sx.astype(np.int64), sy.astype(np.int64), norm)
    got = torch_ops.double_threshold_opencv(_t(sx), _t(sy), _t(keep), _i32(lo), _i32(hi), norm).numpy()
    want = oracle.double_threshold_opencv(sx.astype(np.int64), sy.astype(np.int64), keep, lo, hi, norm)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parity", ["reference", "opencv"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("lo,hi", [(0, 0), (10, 40), (254, 254), (255, 255)])
def test_compute_threshold_map(parity, norm, lo, hi):
    sx, sy = _sobel(80, 256, 9)
    cfg = CannyConfig(height=80, width=256, norm=norm, parity=parity)
    got = torch_ops.compute_threshold_map(_t(sx), _t(sy), _i32(lo), _i32(hi), cfg).numpy()
    want = np.asarray(xla_ops.compute_threshold_map(
        jnp.asarray(sx), jnp.asarray(sy), jnp.int32(lo), jnp.int32(hi), cfg))
    np.testing.assert_array_equal(got, want)


def _all_stages(fr, cfg, lo=10, hi=40, hyster=True):
    """Every stage's buffer vs xla_ops. HYSTER (the bit-packed loop, held
    against JAX round by round in test_torch_bitpack) only when asked: the
    XLA loop recompiles on every eager call."""
    stages = list(CannyStage) if hyster else [s for s in CannyStage if s != CannyStage.HYSTER]
    for stage in stages:
        got = torch_ops.canny_to_stage(_t(fr), _i32(lo), _i32(hi), cfg, stage).numpy()
        want = xla_ops.canny_to_stage(jnp.asarray(fr), jnp.int32(lo), jnp.int32(hi), cfg, stage)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(stage))


@pytest.mark.parametrize("parity", ["reference", "opencv"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("ks", [3, 5, 7])
def test_canny_to_stage_configs(ks, norm, parity):
    cfg = CannyConfig(height=37, width=53, kernel_size=ks, norm=norm, parity=parity,
                      hysteresis_scan_after=2)
    _all_stages(_frame(37, 53, ks), cfg, hyster=(ks, norm, parity) == (3, "l1", "opencv"))


@pytest.mark.parametrize("h,w", SHAPES)
def test_canny_to_stage_shapes(h, w):
    _all_stages(_frame(h, w, 10), CannyConfig(height=h, width=w))


def test_canny_to_stage_matches_oracle():
    fr = _frame(80, 256, 11)
    want = oracle.canny_pipeline(fr)
    cfg = CannyConfig(height=80, width=256)
    for stage, key in xla_ops.STAGE_DISPLAY_KEY.items():
        got = torch_ops.canny_to_stage(_t(fr), _i32(10), _i32(40), cfg, stage).numpy()
        np.testing.assert_array_equal(got, want[key], err_msg=key)


def test_canny_to_stage_grayscale():
    gray = _frame(37, 53, 12)[..., 0].copy()
    _all_stages(gray, CannyConfig(height=37, width=53, channels=1))


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_sobel_xy(h, w):
    blur = oracle.gaussian_blur(oracle.rgb2mono(_frame(h, w, 13)), 5)
    got = torch_ops.sobel_xy(_t(blur))
    want = xla_ops.sobel_xy(jnp.asarray(blur))
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))  # sums / 8: exact


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_grad_slope(h, w, norm):
    """Float planes: within 1e-6 relative of XLA's (sqrt and atan2 round on
    their own in each library; measured at most 1.2e-7)."""
    sx, sy = (x.astype(np.float32) * np.float32(0.125) for x in _sobel(h, w, 14))
    got = torch_ops.grad_slope(_t(sx), _t(sy), 4, norm)
    want = xla_ops.grad_slope(jnp.asarray(sx), jnp.asarray(sy), 4, norm)
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=0)


def test_float2uchar():
    x = np.concatenate([np.linspace(-300, 300, 4001, dtype=np.float32),
                        np.float32([0.5, 254.99, 255.0, 255.5, -0.0])])
    np.testing.assert_array_equal(torch_ops.float2uchar(_t(x)).numpy(),
                                  np.asarray(xla_ops.float2uchar(jnp.asarray(x))))


@pytest.mark.parametrize("parity", ["reference", "opencv"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_canny_all_stages(h, w, norm, parity):
    """Every key of xla_ops.canny_all_stages: integer buffers exactly, the
    float planes grad and slope within 1e-6 relative."""
    cfg = CannyConfig(height=h, width=w, norm=norm, parity=parity, hysteresis_scan_after=2)
    fr = _frame(h, w, 15)
    got = torch_ops.canny_all_stages(_t(fr), _i32(10), _i32(40), cfg)
    want = xla_ops.canny_all_stages(jnp.asarray(fr), jnp.int32(10), jnp.int32(40), cfg)
    assert got.keys() == want.keys()
    for k in want:
        g, e = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == e.dtype, k
        if k in ("grad", "slope"):
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, e, err_msg=k)
    assert set(torch_ops.STAGE_DISPLAY_KEY.items()) == set(xla_ops.STAGE_DISPLAY_KEY.items())
