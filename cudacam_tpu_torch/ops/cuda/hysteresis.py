"""The legacy row-sweep hysteresis of a threshold map.

Port of the TPU sweep kernel (cudacam_tpu/ops/pallas/hysteresis.py:157
``pallas_call`` in ``_make_sweep`` :145 -> ``_sweep_kernel`` :75; entry
``hysteresis_pallas`` :194): full-width row slabs, each saturated locally
with its 8 halo rows on either side and written back, the slabs of a sweep in
order on the updated map, alternating down and up sweeps until one changes
nothing. It is kept, as there, as the independently derived check of the
fused hysteresis (``hysteresis_fused``): a different algorithm that must
reach the same fixed point. The kernel (``csrc/hyst_sweep.cu``) is three
launches: a pack of the map into bit planes on every SM, the slab chain on
one block with the window carried from slab to slab, and the unpack into
the output map (:func:`sweeps_layout` gives the chain's form).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple, Union

import torch

from cudacam_tpu_torch.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)

#: Halo rows of a slab's window on either side (the TPU kernel's ``HALO``).
HALO = 8
#: The default slab height. A window is then 16 + 2 * 8 = 32 rows: exactly one
#: packed word a column, so a promotion step needs no carry across words.
#: (The TPU kernel sizes its slabs to its own fast memory instead; the bytes
#: depend on the slab height only when ``max_iters`` or ``max_local_iters``
#: cuts the call off, so pass ``block_h`` to compare cut-off outputs.)
DEFAULT_BLOCK_H = 16
#: The plain version tests for a local fixed point every this many steps
#: (a step past the fixed point changes nothing, so the bytes are the same).
_PLAIN_CHECK_EVERY = 32
#: Shared memory one block can use on sm_90 (227 KB).
_SMEM_LIMIT = 232448


@dataclasses.dataclass(frozen=True)
class SweepsLayout:
    """The form :func:`hysteresis_sweeps` takes for a map, as the kernel
    library computes it (``cc_hyst_sweeps_layout``, ``csrc/hyst_sweep.cu``):
    ``cols`` columns a thread of the chain's block of ``threads`` threads,
    the window in registers, or 0 for the shared-memory form
    (``smem_bytes`` of it); ``pitch`` words a word row and ``plane_words``
    words in each of the four bit planes of the map (FINAL and CANDIDATE in
    two layouts of ``block_h``-row groups)."""

    cols: int
    threads: int
    pitch: int
    plane_words: int
    smem_bytes: int


def sweeps_layout(h: int, w: int, block_h: Optional[int] = None) -> SweepsLayout:
    """The kernel's layout for an (h, w) map at ``block_h`` (default 16):
    registers with the fewest columns a thread that give it 8 window words,
    where the window has at most five words a column and such a block covers
    the width, else the shared-memory form. Needs the kernel library (a
    host with nvcc)."""
    out = (ctypes.c_longlong * 5)()
    lib = load()
    lib.check(lib.lib.cc_hyst_sweeps_layout(h, w, block_h or DEFAULT_BLOCK_H,
                                            ctypes.cast(out, ctypes.c_void_p)),
              "cc_hyst_sweeps_layout")
    return SweepsLayout(*out)


def _check(thresh: torch.Tensor, max_iters: int, block_h: Optional[int],
           max_local_iters: int) -> int:
    if thresh.dtype != torch.uint8 or thresh.ndim != 2 or thresh.numel() == 0:
        raise ValueError(f"expected a (H, W) uint8 threshold map, got {tuple(thresh.shape)} "
                         f"{thresh.dtype}")
    if max_iters < 0 or max_local_iters < 0:
        raise ValueError("max_iters and max_local_iters must be >= 0")
    if block_h is not None and block_h < 1:
        raise ValueError("block_h must be >= 1")
    return block_h or DEFAULT_BLOCK_H


def _finish(state: torch.Tensor, info: torch.Tensor, remove_candidates: bool,
            return_info: bool):
    if remove_candidates:
        state = torch.where(state == FINAL_EDGE, FINAL_EDGE, NO_EDGE).to(torch.uint8)
    return (state, info) if return_info else state


def _saturate_plain(final: torch.Tensor, cand: torch.Tensor, max_local_iters: int
                    ) -> Tuple[torch.Tensor, int]:
    """At most ``max_local_iters`` promotion steps ``f | (cand & dilate8(f))``
    on one window, zero fill at its edges: (the window's finals, steps)."""
    steps = 0
    cand_f = cand.float()
    f = final.float()
    while steps < max_local_iters:
        before = f
        for _ in range(min(_PLAIN_CHECK_EVERY, max_local_iters - steps)):
            f = torch.maximum(f, cand_f * torch.nn.functional.max_pool2d(f[None, None], 3, 1, 1)[0, 0])
            steps += 1
        if torch.equal(f, before):
            break
    return f > 0, steps


def hysteresis_sweeps_plain(
    thresh: torch.Tensor,
    max_iters: int = 100,
    remove_candidates: bool = True,
    block_h: Optional[int] = None,
    max_local_iters: int = 4096,
    return_info: bool = False,
):
    """Plain PyTorch version of :func:`hysteresis_sweeps`, on any device:
    the same slabs, windows, sweep order and stop tests with tensor ops, the
    stop tests read back to the host. Its ``info`` counts the steps it took,
    which may pass the kernel's (it tests for a local fixed point every
    32 steps)."""
    bh = _check(thresh, max_iters, block_h, max_local_iters)
    h, _ = thresh.shape
    n_slabs = -(-h // bh)
    final, cand = thresh == FINAL_EDGE, thresh == CANDIDATE_EDGE
    sweeps, steps, changed = 0, 0, True
    while True:
        changed = False
        order = range(n_slabs) if sweeps % 2 == 0 else range(n_slabs - 1, -1, -1)
        for b in order:
            r0, r1 = max(0, b * bh - HALO), min(h, b * bh + bh + HALO)
            reached, n = _saturate_plain(final[r0:r1], cand[r0:r1], max_local_iters)
            steps += n
            changed |= bool((reached & ~final[r0:r1]).any())
            final[r0:r1] = reached
        sweeps += 1
        if not (changed and sweeps < 2 * max_iters):
            break
    state = torch.where(final, FINAL_EDGE, thresh).to(torch.uint8)
    info = torch.tensor([sweeps, int(changed), steps], dtype=torch.int32, device=thresh.device)
    return _finish(state, info, remove_candidates, return_info)


def hysteresis_sweeps(
    thresh: torch.Tensor,
    max_iters: int = 100,
    remove_candidates: bool = True,
    block_h: Optional[int] = None,
    max_local_iters: int = 4096,
    return_info: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Hysteresis of an (H, W) uint8 threshold map by row sweeps, the same
    bytes as the JAX package's ``hysteresis_pallas`` for the same explicit
    ``block_h``, converged or cut off.

    Slab b covers rows [b block_h - 8, b block_h + block_h + 8) of the map
    (zero outside it); its result is every CANDIDATE within
    ``max_local_iters`` 8-connected steps of a FINAL inside that window, halo
    rows written back too. The slabs of a sweep run in order on the updated
    map; sweeps alternate down and up, starting down, and stop at the first
    that changes no slab or after ``2 * max_iters`` of them. With
    ``remove_candidates`` the candidates never reached become 0, else they
    keep their 128. ``block_h`` defaults to 16 (:data:`DEFAULT_BLOCK_H`).

    With ``return_info`` the int32 tensor [sweeps run, the last sweep still
    changed a slab, promotion steps taken] comes too, on the map's device.
    Three kernel launches on a CUDA tensor (the pack, the chain, the
    unpack), no host sync; a window that does not fit one SM's shared memory
    raises."""
    bh = _check(thresh, max_iters, block_h, max_local_iters)
    kw = dict(max_iters=max_iters, remove_candidates=remove_candidates, block_h=bh,
              max_local_iters=max_local_iters, return_info=return_info)
    if use_plain(thresh):
        return hysteresis_sweeps_plain(thresh, **kw)
    require_contiguous(thresh)
    h, w = thresh.shape
    lay = sweeps_layout(h, w, bh)
    if lay.smem_bytes > _SMEM_LIMIT:
        raise ValueError(f"a window of {bh + 2 * HALO} rows x {w} columns needs {lay.smem_bytes} "
                         f"bytes of shared memory, a block has {_SMEM_LIMIT}: lower block_h")
    out = torch.empty_like(thresh)
    lib = load()
    planes = torch.empty(4 * lay.plane_words, dtype=torch.int32, device=thresh.device)
    info = torch.empty(3, dtype=torch.int32, device=thresh.device)
    lib.check(
        lib.lib.cc_hyst_sweeps(thresh.data_ptr(), out.data_ptr(), planes.data_ptr(),
                               info.data_ptr(), h, w, bh, max_iters, max_local_iters,
                               int(remove_candidates), thresh.device.index, stream_of(thresh)),
        "hyst_sweeps",
    )
    for _ in range(3):  # the pack, the chain and the unpack
        count_launch("hyst_sweeps")
    return (out, info) if return_info else out
