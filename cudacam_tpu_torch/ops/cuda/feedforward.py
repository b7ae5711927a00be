"""The feed-forward kernels: raw frames -> packed planes (``ff_pack``) or
stage buffers (``ff_stages``).

``ff_pack`` wraps ``csrc/ff_pack.cu``, which replaces the TPU megakernel's
ingest and feed-forward chain (cudacam_tpu/ops/pallas/megakernel.py:243
``_ingest_chain_pack``; per frame of a batch in ``_kernel_batched`` :958).
``ff_stages`` wraps ``csrc/ff_stages.cu``, which replaces the TPU
feed-forward kernel (cudacam_tpu/ops/pallas/feedforward.py:810, entries
``feed_forward_to_stage`` :604, ``feed_forward_all_stages`` :651 and
``feed_forward_nmsq`` :693). Both run the one stencil chain of
``csrc/stage_chain.cuh``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.stages import CannyStage
from cudacam_tpu_torch.ops import bitpack, torch_ops
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)

#: ``ff_stages``' threshold-free output: the int32 ``keep * g`` plane (the
#: NMS-masked comparable magnitude), emitted alone.
NMSQ = "NMSQ"

#: Every u8 buffer ``ff_stages`` emits, in pipeline order.
FF_STAGES = (CannyStage.MONO, CannyStage.GAUSSIAN, CannyStage.GRADIENT,
             CannyStage.NMS, CannyStage.THRESH)

Stage = Union[CannyStage, str]


def _check_frames(frames: torch.Tensor, batched: bool) -> None:
    lead = 1 if batched else 0
    nd = frames.ndim - lead
    if frames.dtype != torch.uint8 or not (nd == 2 or (nd == 3 and frames.shape[-1] == 3)):
        want = "(B, H, W, 3) or (B, H, W)" if batched else "(H, W, 3) or (H, W)"
        raise ValueError(
            f"frames must be {want} uint8, got {tuple(frames.shape)} {frames.dtype}"
        )
    if min(frames.shape[: lead + 2]) < 1:
        raise ValueError("frame must not be empty")


def _check_thresholds(thresholds: torch.Tensor) -> None:
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
    """Plain PyTorch version of :func:`ff_pack`, on any device: the packed
    planes of :func:`ff_stages_plain`'s threshold map."""
    (thresh,) = ff_stages_plain(frame, thresholds, (CannyStage.THRESH,), kernel_size=kernel_size,
                                grad_coeff=grad_coeff, norm=norm, parity=parity)
    return bitpack.pack_pair(thresh)


def _ff_pack(frames: torch.Tensor, thresholds: torch.Tensor, kw: dict):
    """One launch for a (B, H, W[, 3]) batch -> (B, ceil(H/32), W) planes."""
    require_contiguous(frames, thresholds)
    b, h, w = frames.shape[:3]
    f = torch.empty((b, (h + 31) // 32, w), dtype=torch.int32, device=frames.device)
    p = torch.empty_like(f)
    lib = load()
    lib.check(
        lib.lib.cc_ff_pack(
            frames.data_ptr(), thresholds.data_ptr(), f.data_ptr(), p.data_ptr(),
            b, h, w, 1 if frames.ndim == 3 else 3, kw["kernel_size"], kw["grad_coeff"],
            int(kw["norm"] == "l2"), int(kw["parity"] == "reference"), frames.device.index,
            stream_of(frames),
        ),
        "ff_pack",
    )
    count_launch("ff_pack")
    return f, p


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
    _check_frames(frame, batched=False)
    _check_thresholds(thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frame, thresholds):
        return ff_pack_plain(frame, thresholds, **kw)
    f, p = _ff_pack(frame.unsqueeze(0), thresholds, kw)
    return f[0], p[0]


def ff_pack_batched(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) or (B, H, W) uint8 frames -> (B, ceil(H/32), W) int32
    FINAL and CANDIDATE planes, one launch for the batch. The plain version
    is :func:`ff_pack_plain` frame by frame."""
    _check_frames(frames, batched=True)
    _check_thresholds(thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frames, thresholds):
        planes = [ff_pack_plain(fr, thresholds, **kw) for fr in frames]
        return torch.stack([f for f, _ in planes]), torch.stack([p for _, p in planes])
    return _ff_pack(frames, thresholds, kw)


def _check_stages(stages: Sequence[Stage], thresholds: Optional[torch.Tensor]) -> Tuple[Stage, ...]:
    stages = tuple(s if s == NMSQ else CannyStage(s) for s in stages)
    if not stages or len(set(stages)) != len(stages):
        raise ValueError(f"stages must be distinct and not empty, got {stages}")
    if NMSQ in stages and len(stages) > 1:
        raise ValueError("NMSQ is emitted alone")
    if CannyStage.HYSTER in stages:
        raise ValueError("HYSTER is not a feed-forward stage")
    if CannyStage.THRESH in stages and thresholds is None:
        raise ValueError("THRESH needs thresholds")
    if thresholds is not None:
        _check_thresholds(thresholds)
    return stages


def ff_stages_plain(
    frame: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    stages: Sequence[Stage],
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`ff_stages` (``torch_ops``' stage
    buffers), on any device."""
    stages = _check_stages(stages, thresholds)
    cfg = CannyConfig(height=frame.shape[0], width=frame.shape[1], kernel_size=kernel_size,
                      grad_coeff=grad_coeff, norm=norm, parity=parity)
    out = {CannyStage.MONO: torch_ops.rgb2mono(frame)}
    if set(stages) - {CannyStage.MONO}:
        out[CannyStage.GAUSSIAN] = torch_ops.gaussian_blur(out[CannyStage.MONO], kernel_size)
    if set(stages) - {CannyStage.MONO, CannyStage.GAUSSIAN}:
        sx, sy = torch_ops.sobel_sums(out[CannyStage.GAUSSIAN])
        coeff = torch_ops.display_coeff(cfg)
        if CannyStage.GRADIENT in stages:
            out[CannyStage.GRADIENT] = torch_ops.nms_magnitude_u8(sx, sy, coeff, norm)
        if CannyStage.NMS in stages:
            out[CannyStage.NMS] = torch_ops.non_max_suppression(sx, sy, coeff, norm)
        if CannyStage.THRESH in stages:
            out[CannyStage.THRESH] = torch_ops.compute_threshold_map(
                sx, sy, thresholds[0], thresholds[1], cfg)
        if NMSQ in stages:
            out[NMSQ] = torch_ops.nms_keep_mask(sx, sy, norm) * torch_ops.comparable_magnitude(
                sx, sy, norm)
    return tuple(out[s] for s in stages)


def ff_stages(
    frame: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    stages: Sequence[Stage],
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, ...]:
    """One pass of the feed-forward chain over an (H, W, 3) BGR or (H, W)
    mono uint8 frame, emitting the (H, W) buffer of each of ``stages``, in
    the order given: any of MONO, GAUSSIAN, GRADIENT, NMS and THRESH as
    uint8 display buffers, or :data:`NMSQ` alone, the int32 ``keep * g``
    plane. ``thresholds`` (int32 [low, high]) is read for THRESH only and
    may be None without it."""
    _check_frames(frame, batched=False)
    stages = _check_stages(stages, thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frame, thresholds):
        return ff_stages_plain(frame, thresholds, stages, **kw)
    require_contiguous(frame, *([thresholds] if thresholds is not None else []))
    h, w = frame.shape[:2]
    outs = {
        s: torch.empty((h, w), dtype=torch.int32 if s == NMSQ else torch.uint8,
                       device=frame.device)
        for s in stages
    }

    def ptr(s):
        return outs[s].data_ptr() if s in outs else None

    lib = load()
    lib.check(
        lib.lib.cc_ff_stages(
            frame.data_ptr(), thresholds.data_ptr() if thresholds is not None else None,
            *(ptr(s) for s in FF_STAGES), ptr(NMSQ), h, w, 1 if frame.ndim == 2 else 3,
            kernel_size, grad_coeff, int(norm == "l2"), int(parity == "reference"),
            frame.device.index, stream_of(frame),
        ),
        "ff_stages",
    )
    count_launch("ff_stages")
    return tuple(outs[s] for s in stages)
