"""Run-to-stage dispatch of the port (``ops/pallas/canny.py`` analog).

Every stage runs the kernels on any frame size: the TPU path's h % 8 /
w % 128 gates and VMEM budgets are its own and do not apply, and there is no
fallback. The same calls take the plain versions on CPU tensors.

* HYSTER: the kernel pipeline of ``ops/cuda/megakernel.py``; a batch is one
  launch of each of its four kernels.
* MONO..THRESH: one pass of the feed-forward kernel ``ff_stages`` (MONO of a
  gray frame is the frame itself). A batch loops over its frames, as the
  JAX package maps over them.
* All stages (``process_all``): one ``ff_stages`` pass emits every display
  buffer, the float inspection planes are plain torch ops on its blur (as
  they are XLA ops in the JAX package), and the edge map comes from the
  threshold map through ``hysteresis_fused`` (K6), the two-kernel path.
"""
from __future__ import annotations

from typing import Dict

import torch

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.stages import CannyStage
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.ops.cuda.feedforward import FF_STAGES, ff_stages
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import hysteresis_fused
from cudacam_tpu_torch.ops.cuda.megakernel import (
    canny_mega_pipeline, canny_mega_pipeline_batched,
)


def ff_kwargs(cfg: CannyConfig) -> dict:
    """The feed-forward kernels' arguments for a config."""
    return dict(kernel_size=cfg.kernel_size, grad_coeff=cfg.grad_coeff, norm=cfg.norm,
                parity=cfg.parity)


def hyster_kwargs(cfg: CannyConfig) -> dict:
    """The round kernels' arguments for a config (``cfg.continuation`` has
    no counterpart: the port's single continuation is exact for all)."""
    return dict(dilate_steps=cfg.hysteresis_inner_steps,
                scan_after=cfg.hysteresis_scan_after,
                max_iters=cfg.max_hysteresis_iters)


def pipeline_kwargs(cfg: CannyConfig) -> dict:
    """The kernel pipeline's arguments for a config."""
    return {**ff_kwargs(cfg), **hyster_kwargs(cfg)}


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
    if final_stage == CannyStage.MONO and frame.ndim == 2:
        return frame  # a gray frame is its own mono
    return ff_stages(frame, thresholds, (final_stage,), **ff_kwargs(cfg))[0]


def canny_to_stage_batched(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    cfg: CannyConfig,
    final_stage: CannyStage,
) -> torch.Tensor:
    """:func:`canny_to_stage` on a (B, H, W[, 3]) batch -> (B, H, W)."""
    if CannyStage(final_stage) == CannyStage.HYSTER:
        edges, _ = canny_mega_pipeline_batched(frames, thresholds, **pipeline_kwargs(cfg))
        return edges
    return torch.stack([canny_to_stage(f, thresholds, cfg, final_stage) for f in frames])


def canny_all_stages(
    frame: torch.Tensor, thresholds: torch.Tensor, cfg: CannyConfig
) -> Dict[str, torch.Tensor]:
    """Every stage buffer of one (H, W[, 3]) uint8 frame, the ten keys of
    ``xla_ops.canny_all_stages``. No host sync."""
    gray = frame.ndim == 2
    stages = FF_STAGES[1:] if gray else FF_STAGES
    bufs = ff_stages(frame, thresholds, stages, **ff_kwargs(cfg))
    mono, blur, grad_disp, nms, thresh = ((frame,) + bufs) if gray else bufs
    sx, sy = torch_ops.sobel_xy(blur)
    grad, slope = torch_ops.grad_slope(sx, sy, cfg.grad_coeff, cfg.norm)
    return {
        "mono": mono,
        "gaussian": blur,
        "sobel_x": sx,
        "sobel_y": sy,
        "grad": grad,
        "slope": slope,
        "gradient_display": grad_disp,
        "nms": nms,
        "thresh": thresh,
        "hyster": hysteresis_fused(thresh, **hyster_kwargs(cfg)),
    }
