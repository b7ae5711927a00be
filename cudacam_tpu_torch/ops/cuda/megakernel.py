"""The main path: frame -> edge map through the hysteresis kernels.

Port of the TPU megakernel and its phase-2 continuation
(cudacam_tpu/ops/pallas/megakernel.py: ``canny_mega`` :448, ``_kernel``
:172, ``_phase1_finalize`` :335, ``_unpack_out`` :130, ``_cont_kernel``
:736, ``canny_mega_pipeline`` :1242). On the GPU the one TPU launch becomes
four kernels on PyTorch's current stream:

1. ``ff_pack`` (ops/cuda/feedforward.py): frame -> packed planes;
2. ``hyst_phase1``: phase-1 dilation rounds, flags[0] = (round count,
   still growing);
3. ``hyst_phase2``: reads flags[0] on the device and returns at once when
   the frame converged, else resumes rounds with the 8-direction scans;
   flags[1] = the final (round count, still growing);
4. ``unpack``: the edge map, every byte written once.

Phase 2 is always launched (no host branch, no readback of the flag); it is
skipped statically only when ``scan_after >= max_iters``, where the cap is
phase 1. That is single-chip truncation identity with the JAX package for
every ``CannyConfig.continuation`` value, so the port takes no such option.

Each wrapper takes its plain version (``ops/bitpack.py``) only for CPU
tensors; for CUDA tensors it launches its kernel or raises. The planes are
updated in place on both routes. The dilation schedule is bitpack's with its
default carry cadence (every 8th step exact across words), fixed in the
kernel as it is in every JAX entry point the port mirrors.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from cudacam_tpu.stages import FINAL_EDGE, NO_EDGE
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda._build import load, require_contiguous, stream_of, use_plain
from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack

_MAX_DILATE_STEPS = 256  # the tile halo (steps columns) must fit shared memory


def _check_planes(f: torch.Tensor, p: torch.Tensor, h: int, flags=None) -> None:
    if f.dtype != torch.int32 or p.dtype != torch.int32 or f.ndim != 2:
        raise ValueError("packed planes must be 2-D int32 tensors")
    if f.shape != p.shape or f.shape[0] != -(-h // 32):
        raise ValueError(f"planes {tuple(f.shape)}/{tuple(p.shape)} do not pack {h} rows")
    if flags is not None and (flags.dtype != torch.int32 or tuple(flags.shape) != (2, 2)):
        raise ValueError("flags must be a (2, 2) int32 tensor")


def _check_steps(dilate_steps: int) -> None:
    if not 1 <= dilate_steps <= _MAX_DILATE_STEPS:
        raise ValueError(f"dilate_steps must be in [1, {_MAX_DILATE_STEPS}] on the GPU")


@functools.lru_cache(maxsize=None)
def _scratch_words(h: int, w: int, phase: int) -> int:
    return load().lib.cc_hyst_scratch_words(h, w, phase)


def _scratch(f: torch.Tensor, h: int, phase: int) -> torch.Tensor:
    n = _scratch_words(h, f.shape[1], phase)
    return torch.empty(n, dtype=torch.int32, device=f.device)


def hyst_phase1(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> None:
    """Phase-1 rounds on the packed planes, in place: ``f`` becomes the
    phase-1 exit state and flags[0] = (round count, still growing)."""
    _check_planes(f, p, h, flags)
    w = f.shape[1]
    if use_plain(f, p, flags):
        nf, it, growing = bitpack.converge_phase1(f, p, h, w, dilate_steps, scan_after, max_iters)
        f.copy_(nf)
        flags[0] = torch.tensor([it, int(growing)], dtype=torch.int32)
        return
    _check_steps(dilate_steps)
    require_contiguous(f, p, flags)
    lib = load()
    scratch = _scratch(f, h, 1)  # stream-ordered: reusable once the kernel ran
    lib.check(
        lib.lib.cc_hyst_phase1(
            f.data_ptr(), p.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
            h, w, dilate_steps, scan_after, max_iters, f.device.index, stream_of(f),
        ),
        "hyst_phase1",
    )
    hyst_phase1.launches += 1


def hyst_phase2(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    max_iters: int = 100,
) -> None:
    """Phase-2 continuation, in place: when flags[0] says still growing,
    resume at its round count with dilations + scans while the state
    changes and the count is below ``max_iters``; flags[1] = the final
    (round count, still growing)."""
    _check_planes(f, p, h, flags)
    w = f.shape[1]
    if use_plain(f, p, flags):
        it0, growing = (int(v) for v in flags[0])
        if growing:
            nf, it, still = bitpack.converge_phase2(f, p, h, w, it0, dilate_steps, max_iters)
            f.copy_(nf)
            flags[1] = torch.tensor([it, int(still)], dtype=torch.int32)
        else:
            flags[1] = flags[0]
        return
    _check_steps(dilate_steps)
    require_contiguous(f, p, flags)
    lib = load()
    scratch = _scratch(f, h, 2)  # stream-ordered: reusable once the kernel ran
    lib.check(
        lib.lib.cc_hyst_phase2(
            f.data_ptr(), p.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
            h, w, dilate_steps, max_iters, f.device.index, stream_of(f),
        ),
        "hyst_phase2",
    )
    hyst_phase2.launches += 1


def unpack_plain(f: torch.Tensor, h: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack`, on any device."""
    reached = bitpack.unpack_mask(f, h)
    out = torch.full(reached.shape, NO_EDGE, dtype=torch.uint8, device=f.device)
    return out.masked_fill_(reached, FINAL_EDGE)


def unpack(f: torch.Tensor, h: int) -> torch.Tensor:
    """(ceil(h/32), W) FINAL plane -> (h, W) uint8 edge map: 255 where the
    bit is set, else 0 (remaining candidates are dropped)."""
    if f.dtype != torch.int32 or f.ndim != 2 or f.shape[0] != -(-h // 32):
        raise ValueError(f"plane {tuple(f.shape)} does not pack {h} rows")
    if use_plain(f):
        return unpack_plain(f, h)
    require_contiguous(f)
    out = torch.empty((h, f.shape[1]), dtype=torch.uint8, device=f.device)
    lib = load()
    lib.check(
        lib.lib.cc_unpack(
            f.data_ptr(), out.data_ptr(), h, f.shape[1], f.device.index, stream_of(f)
        ),
        "unpack",
    )
    unpack.launches += 1
    return out


for _fn in (hyst_phase1, hyst_phase2, unpack):
    _fn.launches = 0


def canny_mega(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame -> (F, P, flags) at the end of phase 1: what the TPU
    megakernel exports when a frame is still growing at ``scan_after``.
    flags is (2, 2) int32; row 0 holds (round count, still growing)."""
    f, p = ff_pack(
        frame, thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity,
    )
    flags = torch.empty((2, 2), dtype=torch.int32, device=frame.device)
    hyst_phase1(
        f, p, flags, frame.shape[0], dilate_steps=dilate_steps,
        scan_after=scan_after, max_iters=max_iters,
    )
    return f, p, flags


def canny_mega_pipeline(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame -> ((H, W) uint8 edge map, (2, 2) int32 flags): phase-1 exit
    in row 0, final (round count, still growing) in row 1. No host sync."""
    h = frame.shape[0]
    f, p, flags = canny_mega(
        frame, thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity, dilate_steps=dilate_steps,
        scan_after=scan_after, max_iters=max_iters,
    )
    if scan_after < max_iters:
        hyst_phase2(f, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters)
    else:  # the cap is phase 1: its exit state is final
        flags[1] = flags[0]
    return unpack(f, h), flags
