"""Run-to-stage dispatch of the port (``ops/pallas/canny.py`` analog).

Every stage runs the kernels on any frame size: the TPU path's h % 8 /
w % 128 gates and VMEM budgets are its own and do not apply, and there is no
fallback. The same calls take the plain versions on CPU tensors.

* HYSTER: the kernel pipeline of ``ops/cuda/megakernel.py``; a batch is one
  launch of each of its four kernels.
* MONO..THRESH: one pass of the feed-forward kernel ``ff_stages`` (MONO of a
  gray frame is the frame itself); a batch is one launch for its frames
  (the JAX package maps over them).
* All stages (``process_all``): one ``ff_stages`` pass emits every display
  buffer, the float inspection planes are plain torch ops on its blur (as
  they are XLA ops in the JAX package), and the edge map comes from the
  threshold map through ``hysteresis_fused`` (K6), the two-kernel path. A
  batch is the same five launches and torch ops over (B, H, W), the edge
  maps through ``hysteresis_fused_batched`` (the JAX package maps over the
  frames).
* The threshold sweep: one ``ff_stages`` pass emits the int32 ``keep * g``
  plane, the pairs become comparable-domain bounds (plain torch ops, as XLA
  ops in the JAX package), and ``sweep_fused`` (K5) runs every pair with the
  monotone seed. One executor at every K and frame size: the JAX package's
  switch to unseeded tails past K = 64 or at 8K (a VMEM limit) has no
  counterpart, so there the port's maps cut off by the round cap are the
  seeded ones, and converged maps are equal either way.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.stages import FINAL_EDGE, CannyStage
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.ops.cuda.feedforward import (
    FF_STAGES, NMSQ, ff_stages, ff_stages_batched,
)
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
    hysteresis_fused, hysteresis_fused_batched, sweep_fused,
)
from cudacam_tpu_torch.ops.cuda.megakernel import (
    canny_mega_pipeline, canny_mega_pipeline_batched,
)


def ff_kwargs(cfg: CannyConfig) -> dict:
    """The feed-forward kernels' arguments for a config."""
    return dict(kernel_size=cfg.kernel_size, grad_coeff=cfg.grad_coeff, norm=cfg.norm,
                parity=cfg.parity)


def hyster_kwargs(cfg: CannyConfig) -> dict:
    """The round kernels' arguments for a config."""
    return dict(dilate_steps=cfg.hysteresis_inner_steps,
                scan_after=cfg.hysteresis_scan_after,
                max_iters=cfg.max_hysteresis_iters)


def pipeline_kwargs(cfg: CannyConfig) -> dict:
    """The kernel pipeline's arguments for a config (the whole-frame path
    adds ``continuation``; the tile export has no such choice)."""
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
        edge, _ = canny_mega_pipeline(frame, thresholds, **pipeline_kwargs(cfg),
                                      continuation=cfg.continuation)
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
    final_stage = CannyStage(final_stage)
    if final_stage == CannyStage.HYSTER:
        edges, _ = canny_mega_pipeline_batched(frames, thresholds, **pipeline_kwargs(cfg),
                                               continuation=cfg.continuation)
        return edges
    if final_stage == CannyStage.MONO and frames.ndim == 3:
        return frames  # gray frames are their own mono
    return ff_stages_batched(frames, thresholds, (final_stage,), **ff_kwargs(cfg))[0]


def canny_all_stages(
    frame: torch.Tensor, thresholds: torch.Tensor, cfg: CannyConfig
) -> Dict[str, torch.Tensor]:
    """Every stage buffer of one (H, W[, 3]) uint8 frame, the ten keys of
    ``xla_ops.canny_all_stages``; of a (B, H, W[, 3]) batch, each key
    stacked over the frames, from the same five launches (one
    ``ff_stages``, :func:`hysteresis_fused_batched`'s four) and the same
    torch ops as one frame. No host sync."""
    gray = cfg.channels == 1
    batched = frame.ndim == (3 if gray else 4)
    stages = FF_STAGES[1:] if gray else FF_STAGES
    run = ff_stages_batched if batched else ff_stages
    bufs = run(frame, thresholds, stages, **ff_kwargs(cfg))
    mono, blur, grad_disp, nms, thresh = ((frame,) + bufs) if gray else bufs
    sx, sy = torch_ops.sobel_xy(blur)
    grad, slope = torch_ops.grad_slope(sx, sy, cfg.grad_coeff, cfg.norm)
    hyster = (hysteresis_fused_batched(thresh, **hyster_kwargs(cfg)) if batched
              else hysteresis_fused(thresh, **hyster_kwargs(cfg)))
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
        "hyster": hyster,
    }


def sweep_bounds(lows: torch.Tensor, highs: torch.Tensor, cfg: CannyConfig) -> torch.Tensor:
    """(K,) int32 lows and highs -> (2K,) int32 [lo_0, hi_0, ...] bounds on
    the ``keep * g`` plane (kg > hi is FINAL, kg > lo at least CANDIDATE),
    as ``threshold_sweep_pallas``' ``cmp_bounds`` derives them: 'reference'
    parity ``threshold_magnitude_bound(t) - 1`` (floor division, lows
    unclamped); 'opencv' parity the thresholds clipped to [0, 2048], squared
    for l2. Plain torch ops on the thresholds' device."""
    if cfg.parity == "reference":
        lo, hi = (torch_ops.threshold_magnitude_bound(t, cfg.grad_coeff, cfg.norm) - 1
                  for t in (lows, highs))
    else:
        lo, hi = (t.to(torch.int32).clamp(0, 2048) for t in (lows, highs))
        if cfg.norm == "l2":
            lo, hi = lo * lo, hi * hi
    return torch.stack([lo, hi], dim=1).reshape(-1).to(torch.int32)


def threshold_sweep(
    frame: torch.Tensor, lows: torch.Tensor, highs: torch.Tensor, cfg: CannyConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge maps of one (H, W[, 3]) uint8 frame for K (low, high) pairs,
    (K,) int32 tensors on the frame's device: ((K, H, W) uint8 maps, (K,)
    int32 FINAL-edge counts), as ``threshold_sweep_pallas`` gives them. No
    host sync."""
    (kg,) = ff_stages(frame, None, (NMSQ,), **ff_kwargs(cfg))
    maps = sweep_fused(kg, sweep_bounds(lows, highs, cfg), monotone_seed=True,
                       **hyster_kwargs(cfg))
    return maps, (maps == FINAL_EDGE).sum((1, 2), dtype=torch.int32)
