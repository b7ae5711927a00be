"""The main path: frames -> edge maps through the hysteresis kernels.

Port of the TPU megakernel, its batch form and its phase-2 continuation
(cudacam_tpu/ops/pallas/megakernel.py: ``canny_mega`` :448, ``_kernel``
:172, ``_phase1_finalize`` :335, ``_unpack_out`` :130, ``_cont_kernel``
:736, ``canny_mega_pipeline`` :1242; ``canny_mega_batched`` :1032,
``_kernel_batched`` :958, ``canny_mega_pipeline_batched`` :1132). On the GPU
the one TPU launch becomes four kernels on PyTorch's current stream, each
launched once for a whole (B, ...) batch; a single frame is B = 1 of the
same kernels:

1. ``ff_pack`` (ops/cuda/feedforward.py): frames -> packed planes;
2. ``hyst_phase1``: phase-1 dilation rounds, per frame: flags[b, 0] =
   (round count, still growing);
3. ``hyst_phase2``: reads flags[b, 0] on the device, continues only the
   frames still growing with rounds of dilations + 8-direction scans, and
   returns at once when none is; flags[b, 1] = the final (round count,
   still growing);
4. ``unpack``: the edge maps, every byte written once.

The tile-sharded path (parallel/sharded.py) runs the same kernels over a
batch of halo-extended tiles: :func:`mega_export` replaces the export-mode
megakernel (``canny_mega_export`` :607 -> ``_mega_call`` :569 with
``export_only``: ``ff_pack`` over a :class:`Tiling`, then phase 1), and
:func:`unpack_core` replaces the core unpack (``unpack_core_call`` :689 ->
``_unpack_core_kernel`` :653, ``pallas_call`` :714).

Phase 2 is always launched (no host branch, no readback of a flag); it is
skipped statically only when ``scan_after >= max_iters``, where the cap is
phase 1. ``continuation`` picks its form: ``'kernel'`` (and ``'auto'``) is
the whole-frame ``hyst_phase2`` at every size, single-chip truncation
identity with the JAX package's ``'pallas'`` and ``'xla'`` forms;
``'split'`` is the column-split form (``_cont_split`` :921 there, which its
``'auto'`` takes at 8K): :func:`_cont_split`, one launch of
``hysteresis_fused.converge_packed_split`` per frame and then ``unpack``,
equal to ``'kernel'`` on every converged frame and to the JAX package's
split form when the cap cuts it off.

Each wrapper takes its plain version (``ops/bitpack.py``, frame by frame)
only for CPU tensors; for CUDA tensors it launches its kernel or raises. The
planes are updated in place on both routes. The dilation schedule is
bitpack's with its default carry cadence (every 8th step exact across
words), fixed in the kernel as it is in every JAX entry point the port
mirrors.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from cudacam_tpu_torch.stages import FINAL_EDGE, NO_EDGE
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)
from cudacam_tpu_torch.ops.cuda.feedforward import (
    Tiling, ff_pack, ff_pack_batched, ff_pack_plain, ff_pack_tiles,
)

_MAX_DILATE_STEPS = 256  # the tile halo (steps columns) must fit shared memory

CONTINUATIONS = ("auto", "kernel", "split")
#: Internal rounds a slice may take in one seam round of the split form (the
#: JAX package's ``_SPLIT_CHUNK``: part of the result when the cap cuts in).
SPLIT_CHUNK = 8
#: The split form doubles ``n_split`` from 2 while a slice's six planes in
#: the kernel's scratch (FINAL, CANDIDATE, four scan buffers) pass this many
#: bytes: half of the H100's 50 MB L2, so that a slice's step stays in cache
#: beside the frame's own planes. It is locality, not a limit of the kernel
#: (the JAX package's slice budget is a compiler limit); 8K gives 2.
SPLIT_SLICE_BYTES = 25_000_000


def _check_planes(f: torch.Tensor, p: torch.Tensor, h: int, flags=None) -> None:
    """Planes are (hw, w) for one frame or (B, hw, w) for a batch, with
    flags (2, 2) or (B, 2, 2) to match."""
    if f.dtype != torch.int32 or p.dtype != torch.int32 or f.ndim not in (2, 3):
        raise ValueError("packed planes must be (hw, w) or (B, hw, w) int32 tensors")
    if f.shape != p.shape or f.shape[-2] != -(-h // 32) or f.numel() == 0:
        raise ValueError(f"planes {tuple(f.shape)}/{tuple(p.shape)} do not pack {h} rows")
    want = tuple(f.shape[:-2]) + (2, 2)
    if flags is not None and (flags.dtype != torch.int32 or tuple(flags.shape) != want):
        raise ValueError(f"flags must be a {want} int32 tensor")


def _check_steps(dilate_steps: int) -> None:
    if not 1 <= dilate_steps <= _MAX_DILATE_STEPS:
        raise ValueError(f"dilate_steps must be in [1, {_MAX_DILATE_STEPS}] on the GPU")


def _frames(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A batch view of ``x``: one leading frame axis when it has ``ndim``
    dims (a single frame), else ``x`` itself."""
    return x.unsqueeze(0) if x.ndim == ndim else x


@functools.lru_cache(maxsize=None)
def _scratch_words(nb: int, h: int, w: int, phase: int) -> int:
    return load().lib.cc_hyst_scratch_words(nb, h, w, phase)


def _launch_rounds(phase: int, f, p, flags, h: int, *args, name: Optional[str] = None) -> None:
    """One launch of a round kernel, counted as ``hyst_phase1`` /
    ``hyst_phase2`` or as ``name`` (the sharded host loop's local saturate,
    K9, counts its launches as ``saturate_phase1`` / ``saturate_phase2``)."""
    require_contiguous(f, p, flags)
    nb, w = (f.shape[0] if f.ndim == 3 else 1), f.shape[-1]
    lib = load()
    # Stream-ordered: the scratch is reusable once the kernel ran.
    scratch = torch.empty(_scratch_words(nb, h, w, phase), dtype=torch.int32, device=f.device)
    entry = lib.lib.cc_hyst_phase1 if phase == 1 else lib.lib.cc_hyst_phase2
    name = name or f"hyst_phase{phase}"
    lib.check(
        entry(f.data_ptr(), p.data_ptr(), scratch.data_ptr(), flags.data_ptr(), nb, h, w, *args,
              f.device.index, stream_of(f)),
        name,
    )
    count_launch(name)


def hyst_phase1_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> None:
    """Plain PyTorch version of :func:`hyst_phase1`, on any device:
    ``bitpack``'s phase 1 frame by frame."""
    for fb, pb, flb in zip(_frames(f, 2), _frames(p, 2), _frames(flags, 2)):
        nf, it, growing = bitpack.converge_phase1(
            fb, pb, h, fb.shape[1], dilate_steps, scan_after, max_iters)
        fb.copy_(nf)
        flb[0, 0], flb[0, 1] = int(it), int(growing)


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
    """Phase-1 rounds on the packed planes of one frame or a batch, in
    place: each frame's plane becomes its phase-1 exit state and its
    flags[0] = (round count, still growing)."""
    _check_planes(f, p, h, flags)
    if use_plain(f, p, flags):
        hyst_phase1_plain(f, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after,
                          max_iters=max_iters)
        return
    _check_steps(dilate_steps)
    _launch_rounds(1, f, p, flags, h, dilate_steps, scan_after, max_iters)


def hyst_phase2_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    max_iters: int = 100,
) -> None:
    """Plain PyTorch version of :func:`hyst_phase2`, on any device:
    ``bitpack``'s phase 2 on the frames still growing."""
    for fb, pb, flb in zip(_frames(f, 2), _frames(p, 2), _frames(flags, 2)):
        it0, growing = (int(v) for v in flb[0])
        if growing:
            nf, it, still = bitpack.converge_phase2(
                fb, pb, h, fb.shape[1], it0, dilate_steps, max_iters)
            fb.copy_(nf)
            flb[1, 0], flb[1, 1] = int(it), int(still)
        else:
            flb[1] = flb[0]


def hyst_phase2(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    max_iters: int = 100,
) -> None:
    """Phase-2 continuation of one frame or a batch, in place: each frame
    whose flags[0] says still growing resumes at its round count with
    dilations + scans while its state changes and the count is below
    ``max_iters``; every frame's flags[1] = its final (round count, still
    growing)."""
    _check_planes(f, p, h, flags)
    if use_plain(f, p, flags):
        hyst_phase2_plain(f, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters)
        return
    _check_steps(dilate_steps)
    _launch_rounds(2, f, p, flags, h, dilate_steps, max_iters)


def unpack_plain(f: torch.Tensor, h: int, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack`, on any device."""
    if f.ndim == 3:
        maps = torch.stack([unpack_plain(fb, h) for fb in f])
        if index is None:
            return maps
        out = torch.empty_like(maps)
        out[index.long()] = maps
        return out
    reached = bitpack.unpack_mask(f, h)
    out = torch.full(reached.shape, NO_EDGE, dtype=torch.uint8, device=f.device)
    return out.masked_fill_(reached, FINAL_EDGE)


def unpack(f: torch.Tensor, h: int, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(ceil(h/32), W) FINAL plane -> (h, W) uint8 edge map, or a
    (B, ceil(h/32), W) batch -> (B, h, W): 255 where the bit is set, else 0
    (remaining candidates are dropped). With ``index``, a (B,) int32
    permutation of range(B) on the planes' device, plane b lands at
    ``out[index[b]]``."""
    if f.dtype != torch.int32 or f.ndim not in (2, 3) or f.shape[-2] != -(-h // 32):
        raise ValueError(f"plane {tuple(f.shape)} does not pack {h} rows")
    if index is not None and (f.ndim != 3 or index.dtype != torch.int32
                              or tuple(index.shape) != (f.shape[0],)):
        raise ValueError("index must be a (B,) int32 tensor for (B, hw, w) planes")
    if use_plain(f, index):
        return unpack_plain(f, h, index)
    require_contiguous(f, *([index] if index is not None else []))
    nb, w = (f.shape[0] if f.ndim == 3 else 1), f.shape[-1]
    out = torch.empty(tuple(f.shape[:-2]) + (h, w), dtype=torch.uint8, device=f.device)
    lib = load()
    lib.check(
        lib.lib.cc_unpack(f.data_ptr(), out.data_ptr(),
                          index.data_ptr() if index is not None else None, nb, h, w,
                          f.device.index, stream_of(f)),
        "unpack",
    )
    count_launch("unpack")
    return out


def _check_core(f: torch.Tensor, out: torch.Tensor, tiling: Tiling) -> None:
    t = tiling
    if f.dtype != torch.int32 or f.ndim != 3 or tuple(f.shape[1:]) != (-(-t.ext_h // 32), t.ext_w):
        raise ValueError(f"planes {tuple(f.shape)} are not the tiles' (T, ceil(ext_h/32), ext_w)")
    want = (f.shape[0] // t.tiles, t.ny * t.h_loc, t.nx * t.w_loc)
    if f.shape[0] % t.tiles or out.dtype != torch.uint8 or tuple(out.shape) != want:
        raise ValueError(f"out must be a {want} uint8 tensor, got {tuple(out.shape)} {out.dtype}")
    if not (t.e_top + t.h_loc <= t.ext_h and t.e_left + t.w_loc <= t.ext_w):
        raise ValueError("the core does not lie inside the extended tile")


def unpack_core_plain(f: torch.Tensor, out: torch.Tensor, tiling: Tiling) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_core`, on any device."""
    t = tiling
    for k, fk in enumerate(f):
        b, i, j = k // t.tiles, (k // t.nx) % t.ny, k % t.nx
        reached = bitpack.unpack_mask(fk, t.e_top + t.h_loc)[t.e_top:, t.e_left:t.e_left + t.w_loc]
        out[b, i * t.h_loc:(i + 1) * t.h_loc, j * t.w_loc:(j + 1) * t.w_loc] = torch.where(
            reached, FINAL_EDGE, NO_EDGE).to(torch.uint8)
    return out


def unpack_core(f: torch.Tensor, out: torch.Tensor, tiling: Tiling) -> torch.Tensor:
    """The owned cores of (B ny nx, ceil(ext_h/32), ext_w) extended-tile
    FINAL planes -> their places in the (B, ny h_loc, nx w_loc) uint8 edge
    maps ``out``, written in place: 255 where the bit is set, else 0. Tile
    (b, i, j)'s core (rows from ``e_top``, lanes from ``e_left``) lands at
    out[b, i h_loc:, j w_loc:], so a sharded frame needs no gather."""
    _check_core(f, out, tiling)
    if use_plain(f, out):
        return unpack_core_plain(f, out, tiling)
    require_contiguous(f, out)
    t = tiling
    lib = load()
    lib.check(
        lib.lib.cc_unpack_core(f.data_ptr(), out.data_ptr(), f.shape[0], f.shape[1], f.shape[2],
                               t.e_top, t.e_left, t.h_loc, t.w_loc, t.ny, t.nx, out.shape[1],
                               out.shape[2], f.device.index, stream_of(f)),
        "unpack_core",
    )
    count_launch("unpack_core")
    return out


def mega_export_plain(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    tiling: Tiling,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mega_export`, on any device."""
    planes = [ff_pack_plain(fr, thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
                            norm=norm, parity=parity, tiling=tiling) for fr in frames]
    f, p = torch.cat([f for f, _ in planes]), torch.cat([p for _, p in planes])
    flags = torch.zeros((f.shape[0], 2, 2), dtype=torch.int32, device=frames.device)
    hyst_phase1_plain(f, p, flags, tiling.ext_h, dilate_steps=dilate_steps,
                      scan_after=scan_after, max_iters=max_iters)
    return f, p, flags


def mega_export(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    tiling: Tiling,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The export-mode megakernel (K8) on every extended tile of a batch of
    source frames: (F, P, flags) with (B ny nx, ceil(ext_h/32), ext_w) int32
    planes at the local phase-1 exit and (B ny nx, 2, 2) int32 flags, row 0
    of each tile holding (round count, still growing). Two launches:
    ``ff_pack`` in its export mode, then ``hyst_phase1`` over the tiles with
    the extended tile as the schedule extent."""
    f, p = ff_pack_tiles(frames, thresholds, tiling, kernel_size=kernel_size,
                         grad_coeff=grad_coeff, norm=norm, parity=parity)
    flags = torch.zeros((f.shape[0], 2, 2), dtype=torch.int32, device=frames.device)
    hyst_phase1(f, p, flags, tiling.ext_h, dilate_steps=dilate_steps, scan_after=scan_after,
                max_iters=max_iters)
    return f, p, flags


def split_count(h: int, w: int) -> int:
    """``n_split`` of the split continuation for an h x w frame: 2, doubled
    while a slice is over ``SPLIT_SLICE_BYTES`` and the doubled count still
    divides ``w`` (so the result always divides an even ``w``). The JAX
    package's rule is another (one plane + 256 columns against its 2.4 MB
    slice budget); ``tests/test_torch_split.py`` lists where the two part."""
    hw = -(-h // 32)
    n = 2
    while w % (2 * n) == 0 and 6 * 4 * hw * (w // n + 128) > SPLIT_SLICE_BYTES:
        n *= 2
    return n


def _cont_split(f, p, flags, h: int, dilate_steps: int, max_iters: int) -> torch.Tensor:
    """The column-split phase-2 continuation of a (B, hw, w) batch at its
    phase-1 exit, in place, then the edge maps: per frame one
    ``converge_packed_split`` (resuming the round budget at the frame's
    phase-1 count, ``scan_after`` 0, ``SPLIT_CHUNK`` internal rounds; gated on
    the frame's growing flag on the device), then ``unpack``, as the kernel
    route ends. B + 1 launches whatever the cap, no host sync.

    ``n_split`` is :func:`split_count`'s, not the JAX package's rule, and
    it is part of the bytes when the cap cuts a frame off: a truncated
    output equals the JAX package's ``cont='split'`` only for frame sizes
    where the two rules agree (``tests/test_torch_split.py`` lists them:
    every size the tests and ``chip_smoke.py`` run, 8K and 8640x15360
    included; they part at 5760x10240, 2 against 4, and 6480x11520, 4
    against 8). Converged outputs equal it everywhere, and
    ``converge_packed_split`` with an explicit ``n_split`` stays byte-equal
    to its JAX counterpart at every size."""
    from cudacam_tpu_torch.ops.cuda.hysteresis_fused import converge_packed_split

    w = f.shape[-1]
    n_split = split_count(h, w)
    for fb, pb, flb in zip(f, p, flags):
        converge_packed_split(fb, pb, flb, h, n_split, dilate_steps=dilate_steps, scan_after=0,
                              max_iters=max_iters, chunk=SPLIT_CHUNK)
    return unpack(f, h)


def _phase2(f, p, flags, h: int, dilate_steps: int, scan_after: int, max_iters: int) -> None:
    """Phase 2 after phase 1 or, when the cap is phase 1, its exit state as
    final."""
    if scan_after < max_iters:
        hyst_phase2(f, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters)
    else:
        flags[..., 1, :] = flags[..., 0, :]


def converge(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> None:
    """Both phases on packed planes (one frame or a batch), in place, with
    ``flags`` filled in. No host sync."""
    hyst_phase1(f, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after,
                max_iters=max_iters)
    _phase2(f, p, flags, h, dilate_steps, scan_after, max_iters)


def converge_unpack(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> torch.Tensor:
    """:func:`converge`, then the edge maps."""
    converge(f, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after,
             max_iters=max_iters)
    return unpack(f, h)


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


def canny_mega_batched(
    frames: torch.Tensor,
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
    """(B, H, W, 3) or (B, H, W) frames -> (F, P, flags) at the end of
    phase 1, two launches for the batch: (B, ceil(H/32), W) planes and
    (B, 2, 2) flags, row 0 of each frame holding (round count, still
    growing)."""
    f, p = ff_pack_batched(
        frames, thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity,
    )
    flags = torch.empty((frames.shape[0], 2, 2), dtype=torch.int32, device=frames.device)
    hyst_phase1(
        f, p, flags, frames.shape[1], dilate_steps=dilate_steps,
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
    continuation: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame -> ((H, W) uint8 edge map, (2, 2) int32 flags): phase-1 exit
    in row 0, final (round count, still growing) in row 1. No host sync."""
    edges, flags = canny_mega_pipeline_batched(
        frame.unsqueeze(0), thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity, dilate_steps=dilate_steps, scan_after=scan_after,
        max_iters=max_iters, continuation=continuation,
    )
    return edges[0], flags[0]


def canny_mega_pipeline_batched(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    continuation: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W[, 3]) frames -> ((B, H, W) uint8 edge maps, (B, 2, 2) int32
    flags), four launches whatever B is. Frame by frame it equals
    :func:`canny_mega_pipeline`: phase 2 continues only the frames still
    growing at ``scan_after``. With ``continuation='split'`` and an even
    width the continuation is :func:`_cont_split` (3 + B launches); an odd
    width has no column split and takes the whole-frame kernel, as the JAX
    package's policy does. No host sync."""
    if continuation not in CONTINUATIONS:
        raise ValueError(f"continuation must be one of {CONTINUATIONS}, got {continuation!r}")
    f, p, flags = canny_mega_batched(
        frames, thresholds, kernel_size=kernel_size, grad_coeff=grad_coeff,
        norm=norm, parity=parity, dilate_steps=dilate_steps, scan_after=scan_after,
        max_iters=max_iters,
    )
    h = frames.shape[1]
    if continuation == "split" and scan_after < max_iters and f.shape[-1] % 2 == 0:
        return _cont_split(f, p, flags, h, dilate_steps, max_iters), flags
    _phase2(f, p, flags, h, dilate_steps, scan_after, max_iters)
    return unpack(f, h), flags
