"""``ff_pack``: raw frame -> packed hysteresis planes (front half of K1).

Wraps ``csrc/ff_pack.cu``, which replaces the TPU megakernel's ingest and
feed-forward chain (cudacam_tpu/ops/pallas/megakernel.py:243
``_ingest_chain_pack`` with feedforward.py's ``planar_ingest_mono`` :160,
``_valid_mask_i32`` :318, ``_gaussian_rolled`` :130 and ``_stage_chain``
:435). A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from cudacam_tpu.config import CannyConfig
from cudacam_tpu_torch.ops import bitpack, torch_ops
from cudacam_tpu_torch.ops.cuda._build import load, require_contiguous, stream_of, use_plain


def _check(frame: torch.Tensor, thresholds: torch.Tensor) -> None:
    if frame.dtype != torch.uint8 or not (
        frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] == 3)
    ):
        raise ValueError(
            f"frame must be (H, W, 3) or (H, W) uint8, got {tuple(frame.shape)} {frame.dtype}"
        )
    if min(frame.shape[:2]) < 1:
        raise ValueError("frame must not be empty")
    if thresholds.dtype != torch.int32 or tuple(thresholds.shape) != (2,):
        raise ValueError("thresholds must be an int32 tensor [low, high]")


def ff_pack_plain(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ff_pack`, on any device."""
    h, w = frame.shape[:2]
    cfg = CannyConfig(
        height=h, width=w, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity,
    )
    mono = torch_ops.rgb2mono(frame)
    sum_x, sum_y = torch_ops.sobel_sums(torch_ops.gaussian_blur(mono, kernel_size))
    thresh = torch_ops.compute_threshold_map(sum_x, sum_y, thresholds[0], thresholds[1], cfg)
    return bitpack.pack_pair(thresh)


def ff_pack(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) BGR or (H, W) mono uint8 frame and an int32 [low, high]
    tensor -> packed FINAL and CANDIDATE planes, (ceil(H/32), W) int32."""
    _check(frame, thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frame, thresholds):
        return ff_pack_plain(frame, thresholds, **kw)
    require_contiguous(frame, thresholds)
    h, w = frame.shape[:2]
    f = torch.empty(((h + 31) // 32, w), dtype=torch.int32, device=frame.device)
    p = torch.empty_like(f)
    lib = load()
    lib.check(
        lib.lib.cc_ff_pack(
            frame.data_ptr(), thresholds.data_ptr(), f.data_ptr(), p.data_ptr(),
            h, w, 1 if frame.ndim == 2 else 3, kernel_size, grad_coeff,
            int(norm == "l2"), int(parity == "reference"), frame.device.index,
            stream_of(frame),
        ),
        "ff_pack",
    )
    ff_pack.launches += 1
    return f, p


ff_pack.launches = 0
