"""Run-to-stage dispatch of the port (``ops/pallas/canny.py`` analog).

HYSTER runs the kernel pipeline of ``ops/cuda/megakernel.py`` on any frame
size: the TPU path's h % 8 / w % 128 gates are DMA granules and do not
apply. On a CUDA tensor the other stages are not ported yet; on a CPU
tensor they run the plain ops.
"""
from __future__ import annotations

import torch

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.stages import CannyStage
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline


def pipeline_kwargs(cfg: CannyConfig) -> dict:
    """The kernel pipeline's arguments for a config (``cfg.continuation``
    has no counterpart: the port's single continuation is exact for all)."""
    return dict(
        kernel_size=cfg.kernel_size,
        grad_coeff=cfg.grad_coeff,
        norm=cfg.norm,
        parity=cfg.parity,
        dilate_steps=cfg.hysteresis_inner_steps,
        scan_after=cfg.hysteresis_scan_after,
        max_iters=cfg.max_hysteresis_iters,
    )


def canny_to_stage(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    cfg: CannyConfig,
    final_stage: CannyStage,
) -> torch.Tensor:
    """Cumulative pipeline to ``final_stage`` on one (H, W[, 3]) uint8
    frame, with thresholds an int32 [low, high] tensor on the frame's
    device; returns the stage's (H, W) uint8 buffer."""
    final_stage = CannyStage(final_stage)
    if final_stage == CannyStage.HYSTER:
        edge, _ = canny_mega_pipeline(frame, thresholds, **pipeline_kwargs(cfg))
        return edge
    if frame.device.type != "cpu":
        raise NotImplementedError(
            f"stage {final_stage.name} on a {frame.device.type} tensor: only HYSTER "
            "runs on the GPU so far; the display stages come with the "
            "feed-forward kernel K7 (ROADMAP Queue 1 item 8)"
        )
    return torch_ops.canny_to_stage(frame, thresholds[0], thresholds[1], cfg, final_stage)
