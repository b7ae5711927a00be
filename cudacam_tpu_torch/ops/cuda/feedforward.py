"""The feed-forward kernels: raw frames -> packed planes (``ff_pack``) or
stage buffers (``ff_stages``).

``ff_pack`` wraps ``csrc/ff_pack.cu``, which replaces the TPU megakernel's
ingest and feed-forward chain (cudacam_tpu/ops/pallas/megakernel.py:243
``_ingest_chain_pack``; per frame of a batch in ``_kernel_batched`` :958;
per halo-extended tile of a sharded frame in the export mode,
``canny_mega_export`` :607, described by a :class:`Tiling`).
``ff_stages`` wraps ``csrc/ff_stages.cu``, which replaces the TPU
feed-forward kernel (cudacam_tpu/ops/pallas/feedforward.py:810, entries
``feed_forward_to_stage`` :604, ``feed_forward_all_stages`` :651 and
``feed_forward_nmsq`` :693; with ``origin`` / ``image_size`` on the tiles of
a sharded frame, as ``parallel/sharded.py::local_feed_forward_pallas`` :255
passes them; a batch of whole frames in one launch, ``ff_stages_batched``).
Both walk the pieces of ``csrc/ff_walk.cuh`` with the one stencil chain of
``csrc/stage_chain.cuh``. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
from torch.autograd import profiler as autograd_profiler

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.stages import CannyStage
from cudacam_tpu_torch.ops import bitpack, torch_ops
from cudacam_tpu_torch.ops.cuda._build import (
    close_span, count_launch, load, open_span, require_contiguous, stream_of, use_plain,
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


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The extended tiles that one ``ff_pack`` launch packs from a batch of
    source frames. Each source frame carries an ``ny`` x ``nx`` grid of
    tiles; tile (i, j) owns the ``h_loc`` x ``w_loc`` core at global
    ``(core_origin[0] + i h_loc, core_origin[1] + j w_loc)`` of an
    ``image``-sized image and is packed over its extended tile,
    ``ext_h`` x ``ext_w`` pixels from ``e_top`` rows above and ``e_left``
    columns left of the core. A source frame's pixel (0, 0) lies at global
    ``src_origin``; pixels outside the source or the image read as zero.
    ``ring`` (rows, columns) is the pollution ring zeroed at the extended
    tile's edges (megakernel.py:301-317). A whole frame is one tile with no
    extension (:meth:`whole`)."""

    ny: int
    nx: int
    h_loc: int
    w_loc: int
    e_top: int
    e_left: int
    ext_h: int
    ext_w: int
    image: Tuple[int, int]
    core_origin: Tuple[int, int] = (0, 0)
    src_origin: Tuple[int, int] = (0, 0)
    ring: Tuple[int, int] = (0, 0)

    @classmethod
    def whole(cls, h: int, w: int) -> "Tiling":
        return cls(1, 1, h, w, 0, 0, h, w, (h, w))

    @property
    def tiles(self) -> int:
        """Tiles per source frame."""
        return self.ny * self.nx

    def ext_origin(self, i: int, j: int) -> Tuple[int, int]:
        """Global coordinates of tile (i, j)'s extended pixel (0, 0)."""
        return (self.core_origin[0] + i * self.h_loc - self.e_top,
                self.core_origin[1] + j * self.w_loc - self.e_left)

    def geo(self, src_h: int, src_w: int):
        """The C ABI's 18 ints (csrc/ff_pack.cu ``PackGeo``)."""
        vals = (src_h, src_w, *self.src_origin, *self.image, self.ny, self.nx,
                *self.core_origin, self.h_loc, self.w_loc, self.e_top, self.e_left,
                self.ext_h, self.ext_w, *self.ring)
        return (ctypes.c_int * 18)(*vals)


def _valid(origin: Tuple[int, int], shape: Tuple[int, int], image: Tuple[int, int], device):
    """(h, w) bool: the positions of an (h, w) window at global ``origin``
    that lie inside the ``image``-sized image (feedforward.py
    ``_valid_mask_i32`` :318)."""
    rows = torch.arange(shape[0], device=device) + origin[0]
    cols = torch.arange(shape[1], device=device) + origin[1]
    return (((rows >= 0) & (rows < image[0]))[:, None]
            & ((cols >= 0) & (cols < image[1]))[None, :])


def _window(frame: torch.Tensor, top: int, left: int, h: int, w: int) -> torch.Tensor:
    """The (h, w[, 3]) window of ``frame`` at (top, left), zero outside it."""
    out = frame.new_zeros((h, w) + tuple(frame.shape[2:]))
    y0, y1 = max(top, 0), min(top + h, frame.shape[0])
    x0, x1 = max(left, 0), min(left + w, frame.shape[1])
    if y0 < y1 and x0 < x1:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = frame[y0:y1, x0:x1]
    return out


def ff_pack_plain(
    frame: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    tiling: Optional[Tiling] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ff_pack`, on any device: the packed
    planes of :func:`ff_stages_plain`'s threshold map; with a ``tiling``, the
    (ny nx, ceil(ext_h/32), ext_w) planes of each extended tile, the ring
    zeroed."""
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if tiling is None:
        (thresh,) = ff_stages_plain(frame, thresholds, (CannyStage.THRESH,), **kw)
        return bitpack.pack_pair(thresh)
    t = tiling
    fs, ps = [], []
    for i in range(t.ny):
        for j in range(t.nx):
            oy, ox = t.ext_origin(i, j)
            ext = _window(frame, oy - t.src_origin[0], ox - t.src_origin[1], t.ext_h, t.ext_w)
            (thresh,) = ff_stages_plain(ext.contiguous(), thresholds, (CannyStage.THRESH,),
                                        origin=(oy, ox), image_size=t.image, **kw)
            rr, rc = t.ring
            thresh = thresh.clone()
            if rr:
                thresh[:rr] = 0
                thresh[t.ext_h - rr:] = 0
            if rc:
                thresh[:, :rc] = 0
                thresh[:, t.ext_w - rc:] = 0
            f, p = bitpack.pack_pair(thresh)
            fs.append(f)
            ps.append(p)
    return torch.stack(fs), torch.stack(ps)


def _ff_pack(frames: torch.Tensor, thresholds: torch.Tensor, kw: dict, tiling: Tiling,
             name: str = "ff_pack", span=None):
    """One launch for a (B, H, W[, 3]) batch of source frames -> (B ny nx,
    ceil(ext_h/32), ext_w) planes; counted as ``name`` (``ff_pack_export``
    for the tiles of a sharded frame, K8's front half). ``span``: the
    caller's prep span, ended before the statement that calls the C
    entry."""
    require_contiguous(frames, thresholds)
    b, h, w = frames.shape[:3]
    t = tiling
    f = torch.empty((b * t.tiles, (t.ext_h + 31) // 32, t.ext_w), dtype=torch.int32,
                    device=frames.device)
    p = torch.empty_like(f)
    lib = load()
    if span is not None:
        close_span(span)
    lib.check(
        lib.lib.cc_ff_pack(
            frames.data_ptr(), thresholds.data_ptr(), f.data_ptr(), p.data_ptr(), b,
            t.geo(h, w), 1 if frames.ndim == 3 else 3, kw["kernel_size"], kw["grad_coeff"],
            int(kw["norm"] == "l2"), int(kw["parity"] == "reference"), frames.device.index,
            stream_of(frames),
        ),
        name,
    )
    count_launch(name)
    return f, p


def load_route(frames: torch.Tensor, batched: bool = False) -> str:
    """The load path ``ff_pack`` takes on the card for an (H, W[, 3]) frame,
    or a (B, H, W[, 3]) batch with ``batched``: ``"tma"`` (one tensor-map
    copy a piece; base and row pitch 16-byte aligned) or ``"cp.async"``
    (16-byte chunks row by row). Both run inside the one kernel; neither is
    a fallback."""
    _check_frames(frames, batched)
    if frames.device.type != "cuda":
        raise ValueError("the load route is the card's: frames must lie on a CUDA device")
    lead = 1 if batched else 0
    channels = 3 if frames.ndim - lead == 3 else 1
    return ("tma" if load().lib.cc_ff_pack_route(frames.data_ptr(), frames.shape[lead + 1],
                                                  channels) else "cp.async")


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
    span = open_span("cc.prep.ff_pack") if autograd_profiler._is_profiler_enabled else None
    _check_frames(frame, batched=False)
    _check_thresholds(thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frame, thresholds):
        if span is not None:
            close_span(span)
        return ff_pack_plain(frame, thresholds, **kw)
    f, p = _ff_pack(frame.unsqueeze(0), thresholds, kw, Tiling.whole(*frame.shape[:2]),
                    span=span)
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
    span = open_span("cc.prep.ff_pack") if autograd_profiler._is_profiler_enabled else None
    _check_frames(frames, batched=True)
    _check_thresholds(thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frames, thresholds):
        if span is not None:
            close_span(span)
        planes = [ff_pack_plain(fr, thresholds, **kw) for fr in frames]
        return torch.stack([f for f, _ in planes]), torch.stack([p for _, p in planes])
    return _ff_pack(frames, thresholds, kw, Tiling.whole(*frames.shape[1:3]), span=span)


def ff_pack_tiles(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    tiling: Tiling,
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The export mode: (B, H, W, 3) or (B, H, W) uint8 source frames ->
    the (B ny nx, ceil(ext_h/32), ext_w) int32 FINAL and CANDIDATE planes of
    every extended tile of ``tiling``, tiles in (b, i, j) order, one launch.
    The kernel reads each extended tile straight out of the source frames;
    the plain version is :func:`ff_pack_plain` frame by frame."""
    span = open_span("cc.prep.ff_pack_export") if autograd_profiler._is_profiler_enabled else None
    _check_frames(frames, batched=True)
    _check_thresholds(thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frames, thresholds):
        if span is not None:
            close_span(span)
        planes = [ff_pack_plain(fr, thresholds, tiling=tiling, **kw) for fr in frames]
        return torch.cat([f for f, _ in planes]), torch.cat([p for _, p in planes])
    return _ff_pack(frames, thresholds, kw, tiling, "ff_pack_export", span)


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


def _check_origin(origin, image_size) -> None:
    if (origin is None) != (image_size is None):
        raise ValueError("origin and image_size go together")


def _chain_plain(frame, thresholds, stages, kw, valid) -> dict:
    """``torch_ops``' stage buffers of ``frame``, masked to ``valid`` (a
    bool plane, or None for a whole frame)."""
    cfg = CannyConfig(height=frame.shape[0], width=frame.shape[1], **kw)
    norm = kw["norm"]

    def mask(x):
        return x if valid is None else torch.where(valid, x, torch.zeros_like(x))

    out = {CannyStage.MONO: mask(torch_ops.rgb2mono(frame))}
    if set(stages) - {CannyStage.MONO}:
        out[CannyStage.GAUSSIAN] = mask(
            torch_ops.gaussian_blur(out[CannyStage.MONO], kw["kernel_size"]))
    if set(stages) - {CannyStage.MONO, CannyStage.GAUSSIAN}:
        sx, sy = (mask(v) for v in torch_ops.sobel_sums(out[CannyStage.GAUSSIAN]))
        coeff = torch_ops.display_coeff(cfg)
        if CannyStage.GRADIENT in stages:
            out[CannyStage.GRADIENT] = mask(torch_ops.nms_magnitude_u8(sx, sy, coeff, norm))
        if CannyStage.NMS in stages:
            out[CannyStage.NMS] = mask(torch_ops.non_max_suppression(sx, sy, coeff, norm))
        if CannyStage.THRESH in stages:
            out[CannyStage.THRESH] = mask(torch_ops.compute_threshold_map(
                sx, sy, thresholds[0], thresholds[1], cfg))
        if NMSQ in stages:
            out[NMSQ] = mask(torch_ops.nms_keep_mask(sx, sy, norm)
                             * torch_ops.comparable_magnitude(sx, sy, norm))
    return out


def ff_stages_plain(
    frame: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    stages: Sequence[Stage],
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    origin: Optional[Tuple[int, int]] = None,
    image_size: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`ff_stages` (``torch_ops``' stage
    buffers), on any device. With ``origin`` the frame is a window at that
    global position of an ``image_size`` image: mono, blur and the Sobel
    sums are masked to the image (sharded.py ``local_feed_forward`` :323),
    and GRADIENT, NMS, THRESH and NMSQ are 0 outside it; the chain runs on
    the window padded with zero pixels as deep as the stencils reach, so at
    the window's edges inside the image the blur and the magnitudes beyond
    them come from those zeros, as in the JAX kernel's slab."""
    stages = _check_stages(stages, thresholds)
    _check_origin(origin, image_size)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if origin is None:
        out = _chain_plain(frame, thresholds, stages, kw, None)
        return tuple(out[s] for s in stages)
    r = kernel_size // 2 + 2  # mono rows and columns the stencils reach
    h, w = frame.shape[:2]
    padded = _window(frame, -r, -r, h + 2 * r, w + 2 * r)
    valid = _valid((origin[0] - r, origin[1] - r), (h + 2 * r, w + 2 * r), image_size,
                   frame.device)
    out = _chain_plain(padded, thresholds, stages, kw, valid)
    return tuple(out[s][r:r + h, r:r + w].contiguous() for s in stages)


def _ff_stages(frames, batched, thresholds, stages, kw, origin, image_size):
    """One launch for an (H, W[, 3]) frame, or a (B, H, W[, 3]) batch with
    ``batched`` -> each of ``stages``' (H, W) or (B, H, W) buffers."""
    require_contiguous(frames, *([thresholds] if thresholds is not None else []))
    lead = 1 if batched else 0
    b = frames.shape[0] if batched else 1
    h, w = frames.shape[lead:lead + 2]
    oy, ox = origin if origin is not None else (0, 0)
    ih, iw = image_size if image_size is not None else (h, w)
    shape = frames.shape[:lead + 2]
    outs = {
        s: torch.empty(shape, dtype=torch.int32 if s == NMSQ else torch.uint8,
                       device=frames.device)
        for s in stages
    }

    def ptr(s):
        return outs[s].data_ptr() if s in outs else None

    lib = load()
    lib.check(
        lib.lib.cc_ff_stages(
            frames.data_ptr(), thresholds.data_ptr() if thresholds is not None else None,
            *(ptr(s) for s in FF_STAGES), ptr(NMSQ), b, h, w, oy, ox, ih, iw,
            1 if frames.ndim == lead + 2 else 3,
            kw["kernel_size"], kw["grad_coeff"], int(kw["norm"] == "l2"),
            int(kw["parity"] == "reference"), frames.device.index, stream_of(frames),
        ),
        "ff_stages",
    )
    count_launch("ff_stages")
    return tuple(outs[s] for s in stages)


def ff_stages(
    frame: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    stages: Sequence[Stage],
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
    origin: Optional[Tuple[int, int]] = None,
    image_size: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """One pass of the feed-forward chain over an (H, W, 3) BGR or (H, W)
    mono uint8 frame, emitting the (H, W) buffer of each of ``stages``, in
    the order given: any of MONO, GAUSSIAN, GRADIENT, NMS and THRESH as
    uint8 display buffers, or :data:`NMSQ` alone, the int32 ``keep * g``
    plane. ``thresholds`` (int32 [low, high]) is read for THRESH only and
    may be None without it. With ``origin`` (and ``image_size``) the frame
    is a halo-extended tile at that global position: zero padding is pinned
    to the global image."""
    _check_frames(frame, batched=False)
    stages = _check_stages(stages, thresholds)
    _check_origin(origin, image_size)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frame, thresholds):
        return ff_stages_plain(frame, thresholds, stages, origin=origin, image_size=image_size,
                               **kw)
    return _ff_stages(frame, False, thresholds, stages, kw, origin, image_size)


def ff_stages_batched(
    frames: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    stages: Sequence[Stage],
    *,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> Tuple[torch.Tensor, ...]:
    """:func:`ff_stages` on a (B, H, W, 3) or (B, H, W) uint8 batch: each of
    ``stages``' (B, H, W) buffers, one launch for the batch. The plain
    version is :func:`ff_stages_plain` frame by frame."""
    _check_frames(frames, batched=True)
    stages = _check_stages(stages, thresholds)
    kw = dict(kernel_size=kernel_size, grad_coeff=grad_coeff, norm=norm, parity=parity)
    if use_plain(frames, thresholds):
        per_frame = [ff_stages_plain(f, thresholds, stages, **kw) for f in frames]
        return tuple(torch.stack(bufs) for bufs in zip(*per_frame))
    return _ff_stages(frames, True, thresholds, stages, kw, None, None)
