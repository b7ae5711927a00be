"""Plain PyTorch implementation of every Canny stage.

Port of ``cudacam_tpu/ops/xla_ops.py``: the same integer semantics as the
NumPy oracle (``cudacam_tpu/ops/numpy_oracle.py``), byte for byte, on any
torch device. Every *decision* is integer math; stencil borders are zero
padded. These functions are the plain version the CUDA kernels are held
against (``ops/cuda``), and the path a CPU tensor takes.

Inputs are single frames: (H, W, 3) BGR or (H, W) mono uint8 tensors.
uint8 arithmetic wraps in torch, so every stencil upcasts to int32 first.
Only the float inspection planes (``sobel_xy``, ``grad_slope``) are float.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cudacam_tpu_torch.config import GAUSSIAN_TAPS, CannyConfig, gaussian_kernel_sum
from cudacam_tpu_torch.ops.bitpack import hysteresis_packed
from cudacam_tpu_torch.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE, CannyStage

# The NumPy oracle's constants (cudacam_tpu/ops/numpy_oracle.py): the
# fixed-point BGR -> mono weights (>> 6), the Sobel taps, and tan(22.5 deg)
# and tan(67.5 deg) in Q15 for the NMS sector bins.
B_WT, G_WT, R_WT = 7, 38, 19
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.int64)
SOBEL_Y = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.int64)
TG22 = 13573  # round(tan(22.5 deg) * 2^15)
TG67 = 79109  # round(tan(67.5 deg) * 2^15)


def rgb2mono(bgr: torch.Tensor) -> torch.Tensor:
    """Fixed-point BGR grayscale (weights 7/38/19, >> 6)."""
    if bgr.ndim == 2:
        return bgr.to(torch.uint8)
    px = bgr.to(torch.int32)
    acc = px[..., 0] * B_WT + px[..., 1] * G_WT + px[..., 2] * R_WT
    return torch.clamp(acc >> 6, max=255).to(torch.uint8)


def _conv2d_zero_pad_i32(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Exact int32 2D correlation with zero padding over the last two
    dimensions (a frame or a batch of frames), as a sum of shifted planes of
    the zero-padded input."""
    kh, kw = taps.shape
    r = kh // 2
    h, w = img.shape[-2:]
    padded = F.pad(img.to(torch.int32), (r, r, r, r))
    acc = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for dy in range(kh):
        for dx in range(kw):
            t = int(taps[dy, dx])
            if t:
                acc += t * padded[..., dy : dy + h, dx : dx + w]
    return acc


def gaussian_blur(mono: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Integer Gaussian blur with exact floor division by the tap sum."""
    taps = np.asarray(GAUSSIAN_TAPS[kernel_size], dtype=np.int64)
    acc = _conv2d_zero_pad_i32(mono, taps)
    s = gaussian_kernel_sum(kernel_size)
    return torch.div(acc, s, rounding_mode="floor").to(torch.uint8)


def sobel_sums(blur: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw integer Sobel responses, range [-1020, 1020]."""
    return (
        _conv2d_zero_pad_i32(blur, SOBEL_X),
        _conv2d_zero_pad_i32(blur, SOBEL_Y),
    )


def sobel_xy(blur: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float Sobel planes: the raw sums / 8 (exact in float32)."""
    sum_x, sum_y = sobel_sums(blur)
    return sum_x.to(torch.float32) * 0.125, sum_y.to(torch.float32) * 0.125


def grad_slope(
    sx: torch.Tensor, sy: torch.Tensor, grad_coeff: int = 4, norm: str = "l2"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float magnitude and direction planes for display. Within an ulp or
    so of ``xla_ops.grad_slope`` (the two libraries round sqrt and atan2
    their own way)."""
    if norm == "l2":
        grad = grad_coeff * torch.sqrt(sx * sx + sy * sy)
    else:
        grad = grad_coeff * (sx.abs() + sy.abs())
    return grad.to(torch.float32), torch.atan2(sx, sy).to(torch.float32)


def float2uchar(x: torch.Tensor) -> torch.Tensor:
    """Display conversion: min(|x|, 255) truncated to uint8."""
    return torch.clamp(x.abs(), max=255.0).to(torch.uint8)


def exact_isqrt_i32(m: torch.Tensor) -> torch.Tensor:
    """Exact integer floor-sqrt for int32 values < 2^24 (the float32 cast is
    exact there), with rounding fix-ups in both directions."""
    s = torch.sqrt(m.to(torch.float32)).to(torch.int32)
    s = torch.where(s * s > m, s - 1, s)
    return torch.where((s + 1) * (s + 1) <= m, s + 1, s)


def comparable_magnitude(sum_x: torch.Tensor, sum_y: torch.Tensor, norm: str) -> torch.Tensor:
    """The magnitude every decision compares: sx^2 + sy^2 (L2) or |sx| + |sy|."""
    if norm == "l2":
        return sum_x * sum_x + sum_y * sum_y  # <= 2*1020^2, int32-safe
    return sum_x.abs() + sum_y.abs()


def nms_magnitude_u8(
    sum_x: torch.Tensor, sum_y: torch.Tensor, grad_coeff: int = 4, norm: str = "l2"
) -> torch.Tensor:
    """Exact uint8 NMS magnitude: min(255, (isqrt(m) * coeff) // 8)."""
    if norm == "l2":
        val = (exact_isqrt_i32(sum_x * sum_x + sum_y * sum_y) * grad_coeff) // 8
    else:
        val = (grad_coeff * (sum_x.abs() + sum_y.abs())) // 8
    return torch.clamp(val, max=255).to(torch.uint8)


def threshold_magnitude_bound(t: torch.Tensor, grad_coeff: int, norm: str) -> torch.Tensor:
    """Smallest comparable magnitude whose display value exceeds ``t`` (see
    ``xla_ops.threshold_magnitude_bound`` for the derivation); 1 << 30 for
    t >= 255, where nothing can pass. ``t`` stays a tensor, so a threshold
    change never reads back to the host."""
    t = t.to(torch.int32)
    s_min = torch.div(((t + 1) << 3) + grad_coeff - 1, grad_coeff, rounding_mode="floor")
    bound = s_min * s_min if norm == "l2" else s_min
    return torch.where(t >= 255, torch.full_like(bound, 1 << 30), bound)


def nms_keep_mask(sum_x: torch.Tensor, sum_y: torch.Tensor, norm: str = "l2") -> torch.Tensor:
    """NMS keep decision: both directional neighbours <= centre, Q15 sector
    bins, ties kept."""
    g = comparable_magnitude(sum_x, sum_y, norm)
    h, w = g.shape
    gp = F.pad(g, (1, 1, 1, 1))

    def shift(dy: int, dx: int) -> torch.Tensor:
        return gp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    v = sum_x.abs() << 15
    wmag = sum_y.abs()
    folded_u = torch.where(sum_x >= 0, sum_y, -sum_y)
    bin0 = v < wmag * TG22
    bin2 = v >= wmag * TG67
    pos = folded_u > 0
    q = torch.where(bin0, shift(1, 0), torch.where(bin2, shift(0, 1), torch.where(pos, shift(1, -1), shift(-1, -1))))
    r = torch.where(bin0, shift(-1, 0), torch.where(bin2, shift(0, -1), torch.where(pos, shift(-1, 1), shift(1, 1))))
    return (q <= g) & (r <= g)


def non_max_suppression(
    sum_x: torch.Tensor, sum_y: torch.Tensor, grad_coeff: int = 4, norm: str = "l2"
) -> torch.Tensor:
    """NMS display buffer: keep-masked uint8 magnitude."""
    keep = nms_keep_mask(sum_x, sum_y, norm)
    mag = nms_magnitude_u8(sum_x, sum_y, grad_coeff=grad_coeff, norm=norm)
    return torch.where(keep, mag, torch.zeros_like(mag))


def _classify(final: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    out = torch.full(final.shape, NO_EDGE, dtype=torch.uint8, device=final.device)
    return out.masked_fill_(cand, CANDIDATE_EDGE).masked_fill_(final, FINAL_EDGE)


def double_threshold(nms: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Strict double threshold on the uint8 NMS buffer."""
    n = nms.to(torch.int32)
    return _classify(n > high, n > low)


def double_threshold_opencv(
    sum_x: torch.Tensor,
    sum_y: torch.Tensor,
    keep: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    norm: str = "l2",
) -> torch.Tensor:
    """Double threshold on raw Sobel magnitudes (``parity='opencv'``);
    thresholds clamp to the 2048 domain cap so squaring cannot overflow."""
    low = torch.clamp(torch.as_tensor(low).to(torch.int32), 0, 2048)
    high = torch.clamp(torch.as_tensor(high).to(torch.int32), 0, 2048)
    m = comparable_magnitude(sum_x, sum_y, norm)
    lo_c, hi_c = (low * low, high * high) if norm == "l2" else (low, high)
    return _classify(keep & (m > hi_c), keep & (m > lo_c))


def display_coeff(cfg: CannyConfig) -> int:
    """Magnitude coefficient of the display buffers: grad_coeff in
    'reference' parity, 8 in 'opencv' parity (the raw Sobel magnitude)."""
    return cfg.grad_coeff if cfg.parity == "reference" else 8


def compute_threshold_map(
    sum_x: torch.Tensor,
    sum_y: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    cfg: CannyConfig,
) -> torch.Tensor:
    """NMS + double threshold in the configured parity domain; 'reference'
    compares the comparable magnitude against scalar bounds (no per-pixel
    isqrt)."""
    keep = nms_keep_mask(sum_x, sum_y, cfg.norm)
    if cfg.parity == "reference":
        g = comparable_magnitude(sum_x, sum_y, cfg.norm)
        lo_b = threshold_magnitude_bound(torch.as_tensor(low), cfg.grad_coeff, cfg.norm)
        hi_b = threshold_magnitude_bound(torch.as_tensor(high), cfg.grad_coeff, cfg.norm)
        return _classify(keep & (g >= hi_b), keep & (g >= lo_b))
    return double_threshold_opencv(sum_x, sum_y, keep, low, high, cfg.norm)


def canny_to_stage(
    frame: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    cfg: CannyConfig,
    final_stage: CannyStage,
) -> torch.Tensor:
    """Cumulative run to ``final_stage``; returns its (H, W) uint8 buffer.
    HYSTER runs the bit-packed round schedule of ``ops/bitpack.py``."""
    mono = rgb2mono(frame)
    if final_stage == CannyStage.MONO:
        return mono
    blur = gaussian_blur(mono, cfg.kernel_size)
    if final_stage == CannyStage.GAUSSIAN:
        return blur
    sum_x, sum_y = sobel_sums(blur)
    if final_stage == CannyStage.GRADIENT:
        return nms_magnitude_u8(sum_x, sum_y, display_coeff(cfg), cfg.norm)
    if final_stage == CannyStage.NMS:
        return non_max_suppression(sum_x, sum_y, display_coeff(cfg), cfg.norm)
    thresh = compute_threshold_map(sum_x, sum_y, low, high, cfg)
    if final_stage == CannyStage.THRESH:
        return thresh
    return hysteresis_packed(
        thresh,
        max_iters=cfg.max_hysteresis_iters,
        dilate_steps=cfg.hysteresis_inner_steps,
        scan_after=cfg.hysteresis_scan_after,
    )


def canny_all_stages(
    frame: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    cfg: CannyConfig,
) -> Dict[str, torch.Tensor]:
    """Every stage buffer of one frame (``xla_ops.canny_all_stages``): the
    integer display buffers, the float inspection planes and the edge map.
    The plain version of ``CannyEngine.process_all``."""
    mono = rgb2mono(frame)
    blur = gaussian_blur(mono, cfg.kernel_size)
    sum_x, sum_y = sobel_sums(blur)
    sx, sy = sum_x.to(torch.float32) * 0.125, sum_y.to(torch.float32) * 0.125
    grad, slope = grad_slope(sx, sy, cfg.grad_coeff, cfg.norm)
    thresh = compute_threshold_map(sum_x, sum_y, low, high, cfg)
    return {
        "mono": mono,
        "gaussian": blur,
        "sobel_x": sx,
        "sobel_y": sy,
        "grad": grad,
        "slope": slope,
        "gradient_display": nms_magnitude_u8(sum_x, sum_y, display_coeff(cfg), cfg.norm),
        "nms": non_max_suppression(sum_x, sum_y, display_coeff(cfg), cfg.norm),
        "thresh": thresh,
        "hyster": hysteresis_packed(
            thresh,
            max_iters=cfg.max_hysteresis_iters,
            dilate_steps=cfg.hysteresis_inner_steps,
            scan_after=cfg.hysteresis_scan_after,
        ),
    }


def threshold_sweep(
    frame: torch.Tensor,
    lows: torch.Tensor,
    highs: torch.Tensor,
    cfg: CannyConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge maps for K (low, high) pairs (``xla_ops.threshold_sweep``): mono,
    blur and Sobel once, then the threshold map and the bit-packed
    hysteresis per pair, each pair from a cold start. Returns ((K, H, W)
    uint8 maps, (K,) int32 FINAL-edge counts)."""
    sum_x, sum_y = sobel_sums(gaussian_blur(rgb2mono(frame), cfg.kernel_size))
    maps = [
        hysteresis_packed(
            compute_threshold_map(sum_x, sum_y, lo, hi, cfg),
            max_iters=cfg.max_hysteresis_iters,
            dilate_steps=cfg.hysteresis_inner_steps,
            scan_after=cfg.hysteresis_scan_after,
        )
        for lo, hi in zip(torch.as_tensor(lows, dtype=torch.int32),
                          torch.as_tensor(highs, dtype=torch.int32))
    ]
    out = (torch.stack(maps) if maps
           else torch.empty((0,) + tuple(sum_x.shape), dtype=torch.uint8, device=frame.device))
    return out, (out == FINAL_EDGE).sum((1, 2), dtype=torch.int32)


#: Display buffer key of each stage in :func:`canny_all_stages`' result.
STAGE_DISPLAY_KEY: Dict[CannyStage, str] = {
    CannyStage.MONO: "mono",
    CannyStage.GAUSSIAN: "gaussian",
    CannyStage.GRADIENT: "gradient_display",
    CannyStage.NMS: "nms",
    CannyStage.THRESH: "thresh",
    CannyStage.HYSTER: "hyster",
}
