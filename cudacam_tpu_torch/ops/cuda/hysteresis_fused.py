"""Hysteresis of a threshold map: the two-kernel path's second half.

Port of the TPU fused hysteresis kernel (cudacam_tpu/ops/pallas/
hysteresis_fused.py:365/:373 ``pallas_call``: ``_fused_call`` :310 ->
``_kernel`` :168; entries ``hysteresis_fused`` :386 and
``hysteresis_fused_nmsq`` :435). The one TPU launch (pack, both phases,
unpack) becomes ``pack_thresh`` (``csrc/pack.cu``) followed by the round
kernels and the unpack of ``ops/cuda/megakernel.py``, all on the device with
no readback. It serves ``process_all``'s edge map; the nmsq mode takes the
threshold sweep's int32 ``keep * g`` plane and two bounds instead of a u8 map.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cudacam_tpu.stages import FINAL_EDGE
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)
from cudacam_tpu_torch.ops.cuda.megakernel import converge_unpack


def _check(src: torch.Tensor, bounds: Optional[torch.Tensor]) -> None:
    dtype = torch.uint8 if bounds is None else torch.int32
    if src.dtype != dtype or src.ndim != 2 or src.numel() == 0:
        what = "a (H, W) uint8 threshold map" if bounds is None else "a (H, W) int32 keep*g plane"
        raise ValueError(f"expected {what}, got {tuple(src.shape)} {src.dtype}")
    if bounds is not None and (bounds.dtype != torch.int32 or tuple(bounds.shape) != (2,)):
        raise ValueError("bounds must be an int32 tensor [lo, hi]")


def pack_thresh_plain(
    src: torch.Tensor, bounds: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pack_thresh`, on any device."""
    if bounds is None:
        return bitpack.pack_pair(src)
    lo, hi = bounds.clamp_min(0)
    final = src > hi
    cand = (src > lo) & ~final
    return (bitpack.from_words(bitpack.pack_mask(final)),
            bitpack.from_words(bitpack.pack_mask(cand)))


def pack_thresh(
    src: torch.Tensor, bounds: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed FINAL and CANDIDATE planes, (ceil(H/32), W) int32, of an
    (H, W) uint8 threshold map (FINAL == 255, CANDIDATE == 128); or, with
    int32 ``bounds`` [lo, hi] clamped at 0, of an (H, W) int32 ``keep * g``
    plane (FINAL: kg > hi; CANDIDATE: lo < kg <= hi)."""
    _check(src, bounds)
    if use_plain(src, bounds):
        return pack_thresh_plain(src, bounds)
    require_contiguous(src, *([bounds] if bounds is not None else []))
    h, w = src.shape
    f = torch.empty(((h + 31) // 32, w), dtype=torch.int32, device=src.device)
    p = torch.empty_like(f)
    lib = load()
    lib.check(
        lib.lib.cc_pack_thresh(
            src.data_ptr(), bounds.data_ptr() if bounds is not None else None,
            f.data_ptr(), p.data_ptr(), h, w, int(bounds is not None), src.device.index,
            stream_of(src),
        ),
        "pack_thresh",
    )
    count_launch("pack_thresh")
    return f, p


def _hysteresis(src, bounds, max_iters, dilate_steps, scan_after):
    f, p = pack_thresh(src, bounds)
    flags = torch.empty((2, 2), dtype=torch.int32, device=src.device)
    out = converge_unpack(f, p, flags, src.shape[0], dilate_steps=dilate_steps,
                          scan_after=scan_after, max_iters=max_iters)
    return out, flags


def hysteresis_fused(
    thresh: torch.Tensor,
    max_iters: int = 100,
    remove_candidates: bool = True,
    return_iters: bool = False,
    dilate_steps: int = 16,
    scan_after: int = 10,
):
    """Hysteresis of an (H, W) uint8 threshold map, with the JAX entry's
    arguments: the edge map (255 / 0), bit-identical to
    ``bitpack.hysteresis_packed`` including under the cap. With
    ``remove_candidates=False`` the candidates that were not promoted keep
    their 128; with ``return_iters`` the round count comes too, as a 0-d
    int32 tensor on the map's device (never read back here)."""
    out, flags = _hysteresis(thresh, None, max_iters, dilate_steps, scan_after)
    if not remove_candidates:
        out = torch.where(out == FINAL_EDGE, out, thresh)
    if return_iters:
        return out, flags[1, 0]
    return out


def hysteresis_fused_nmsq(
    kg: torch.Tensor,
    lo_cmp,
    hi_cmp,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
) -> torch.Tensor:
    """Threshold + hysteresis straight from the int32 ``keep * g`` plane
    (``ff_stages``' NMSQ output): FINAL is ``kg > hi_cmp``, CANDIDATE is
    ``lo_cmp < kg <= hi_cmp``, the bounds in the comparable domain and
    clamped at 0. Equals :func:`hysteresis_fused` of the equivalent u8 map."""
    bounds = torch.stack([torch.as_tensor(lo_cmp), torch.as_tensor(hi_cmp)]).to(
        device=kg.device, dtype=torch.int32)
    out, _ = _hysteresis(kg, bounds, max_iters, dilate_steps, scan_after)
    return out
