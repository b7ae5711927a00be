"""Tile-sharded Canny over a (b, y, x) tile mesh with halo exchange.

Port of ``cudacam_tpu/parallel/sharded.py``. A frame batch is cut into
tiles over the mesh (``parallel/mesh.py``); the feed-forward chain runs on
each tile extended by its neighbours' pixels, and hysteresis converges on
bit-packed planes of the extended tile that stay the carried state across
collective rounds (``parallel/packed_halo.py``): pack once per frame,
exchange packed strips per round, unpack once.

HYSTER runs the export megakernel's schedule on every route
(``hyster_pallas_mega`` :382): the feed-forward chain over the whole
extended tile, zero padding pinned to the global image and the pollution
ring of width ``cfg.halo`` zeroed (so the halo slots start with the
neighbours' exact state), phase 1 to the local fixed point (K8,
``ops/cuda/megakernel.py::mega_export``), then at most
``cfg.max_hysteresis_iters`` collective rounds of the local saturate (K9,
``ops/cuda/hysteresis_fused.py::saturate_packed``, or an injected
``local_saturate``) and the strip exchange (``parallel/packed_halo.py``),
and the core unpack (K10,
``unpack_core``), which writes each tile into its place in the output. The
port has no granule padding, so where the TPU's granule padding is zero
(ext_h % 8 == 0, ext_w % 128 == 0) an output cut off by the cap equals the
JAX package's ``backend='pallas'``; converged outputs equal both of its
backends everywhere.

The route follows the tensors' device: the plain versions on the CPU, the
kernels on CUDA, with no backend switch and no fallback. On a one-card
mesh the kernels read each extended tile straight out of the frame batch in
device memory, and the round loop, the two refreshes before it included,
is one launch that ends on the device (``sharded_loop``): a HYSTER call is
four launches whatever the cap, and nothing is read back. Across processes the tile's pixels and strips move
through ``torch.distributed`` and the host reads the all-reduced pending
flag once per round (the host loop, as with an injected local operator). The display stages run ``ff_stages`` on each extended
tile with its global origin (``local_feed_forward_pallas`` :255) and keep
the core.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.ops.cuda.canny import ff_kwargs, hyster_kwargs, pipeline_kwargs
from cudacam_tpu_torch.ops.cuda.feedforward import Tiling, ff_stages
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
from cudacam_tpu_torch.ops.cuda.megakernel import mega_export, unpack_core
from cudacam_tpu_torch.parallel.mesh import COL_AXIS, ROW_AXIS, TileMesh
from cudacam_tpu_torch.ops.packed_strips import Shift, make_geo
from cudacam_tpu_torch.parallel.packed_halo import packed_hysteresis_loop, sharded_loop
from cudacam_tpu_torch.stages import CannyStage

#: ``(f, p) -> (f, growing)``: an injected local operator on the (T, hw, w)
#: planes of the local tiles, as the JAX package's ``local_saturate``.
LocalSaturate = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _exchange_halo(x: torch.Tensor, lo: int, hi: int, dim: int, n: int, shift: Shift,
                   axis: str) -> torch.Tensor:
    """Extend the (L, h, w[, C]) local tiles along ``dim`` (1 rows, 2
    columns) with ``lo`` before and ``hi`` after, taken from the neighbours
    on mesh axis ``axis`` of ``n`` tiles; tiles at the border get zeros (the
    global zero padding). ``lo``/``hi`` must not exceed the tile."""
    if n == 1 or (lo == 0 and hi == 0):
        pad = [0, 0] * (x.ndim - 1 - dim) + [lo, hi]
        return torch.nn.functional.pad(x, pad)
    top, bot = shift(x.narrow(dim, x.shape[dim] - lo, lo).contiguous(),
                     x.narrow(dim, 0, hi).contiguous(), axis)
    return torch.cat([top, x, bot], dim=dim)


def _split_tiles(frames: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """(B, H, W[, C]) -> (B ny nx, H/ny, W/nx[, C]) tiles in (b, y, x) order."""
    b, h, w = frames.shape[:3]
    rest = tuple(frames.shape[3:])
    x = frames.reshape((b, ny, h // ny, nx, w // nx) + rest).transpose(2, 3)
    return x.reshape((b * ny * nx, h // ny, w // nx) + rest)


def _merge_tiles(tiles: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """(B ny nx, h, w) -> (B, ny h, nx w)."""
    _, h, w = tiles.shape
    x = tiles.reshape(-1, ny, nx, h, w).transpose(2, 3)
    return x.reshape(-1, ny * h, nx * w)


class ShardedPipeline:
    """``fn(frames, thresholds)`` running stages MONO..``final_stage`` over
    ``mesh`` (:func:`build_sharded_pipeline`). On a one-card mesh ``frames``
    is the whole (B, H, W[, C]) batch and the result (B, H, W); on a
    distributed mesh both are this process's shard (:func:`shard_frame`):
    (B / mesh batch, H / rows, W / cols[, C]) in, (..., H / rows, W / cols)
    out. ``thresholds`` is the int32 [low, high] tensor on the frames'
    device."""

    def __init__(self, cfg: CannyConfig, mesh: TileMesh, final_stage: CannyStage,
                 local_saturate: Optional[LocalSaturate]) -> None:
        ny, nx = mesh.rows, mesh.cols
        if cfg.height % ny or cfg.width % nx:
            raise ValueError(
                f"frame {cfg.height}x{cfg.width} not divisible by mesh tiles {ny}x{nx}")
        h_loc, w_loc = cfg.height // ny, cfg.width // nx
        if cfg.halo > min(h_loc, w_loc):
            raise ValueError(
                f"stencil halo {cfg.halo} exceeds local tile {h_loc}x{w_loc}; use fewer shards")
        self.cfg, self.mesh, self.final_stage = cfg, mesh, CannyStage(final_stage)
        self.local_saturate = local_saturate
        self.geo = make_geo(h_loc, w_loc, ny=ny, nx=nx)
        g = self.geo
        if mesh.distributed:
            _, i, j = mesh.coords()
            core, grid = (i * h_loc, j * w_loc), (1, 1)
            src = (core[0] - g.e_top, core[1] - g.e_left)
        else:
            core, grid, src = (0, 0), (ny, nx), (0, 0)
        #: The export's tiles: on one card an ny x nx grid read straight out
        #: of each frame; across processes this process's extended tile.
        self.tiling = Tiling(*grid, h_loc, w_loc, g.e_top, g.e_left, g.ext_h, g.ext_w,
                             (cfg.height, cfg.width), core, src,
                             (cfg.halo if ny > 1 else 0, cfg.halo if nx > 1 else 0))
        #: Collective rounds the last HYSTER call took (one int32 on the device).
        self.rounds: Optional[torch.Tensor] = None

    def _check(self, frames: torch.Tensor) -> None:
        c, m = self.cfg.channels, self.mesh
        hw = ((self.geo.h_loc, self.geo.w_loc) if m.distributed
              else (self.cfg.height, self.cfg.width))
        expected = hw + ((c,) if c == 3 else ())
        if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != expected:
            raise ValueError(f"expected uint8 (B,)+{expected}, got {frames.dtype} "
                             f"{tuple(frames.shape)}")

    def extend(self, frames: torch.Tensor) -> torch.Tensor:
        """The local tiles extended to the packed-state grid: (L, ext_h,
        ext_w[, C]), zeros outside the image (``extend2d_asym``)."""
        m, g = self.mesh, self.geo
        tiles = frames if m.distributed else _split_tiles(frames, m.rows, m.cols)
        shift = m.shift()
        x = _exchange_halo(tiles, g.e_top, g.e_bot, 1, m.rows, shift, ROW_AXIS)
        return _exchange_halo(x, g.e_left, g.e_right, 2, m.cols, shift, COL_AXIS)

    def __call__(self, frames: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        self._check(frames)
        if self.final_stage == CannyStage.HYSTER:
            return self._hyster(frames, thresholds)
        return self._display(frames, thresholds)

    def _saturate(self, flags: torch.Tensor):
        """The host loop's local operator: K9, or the injected one."""
        cfg, g = self.cfg, self.geo
        if self.local_saturate is None:
            def saturate(f, p):
                return saturate_packed(f, p, flags, g.ext_h, **hyster_kwargs(cfg))[1]
        else:
            def saturate(f, p):
                nf, growing = self.local_saturate(f, p)
                f.copy_(nf)
                return torch.as_tensor(growing, device=f.device).reshape(-1)
        return saturate

    def _hyster(self, frames: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        m, t, cfg = self.mesh, self.tiling, self.cfg
        src = self.extend(frames) if m.distributed else frames.contiguous()
        f, p, flags = mega_export(src, thresholds, t, **pipeline_kwargs(cfg))
        if m.distributed or self.local_saturate is not None:
            self.rounds = packed_hysteresis_loop(
                f, p, flags[:, 0, 1], self._saturate(flags),
                lambda x, **kw: m.exchange(x, self.geo, **kw), cfg.max_hysteresis_iters)
        else:
            self.rounds = sharded_loop(f, p, flags, (f.shape[0] // t.tiles, t.ny, t.nx), self.geo,
                                       max_rounds=cfg.max_hysteresis_iters, **hyster_kwargs(cfg))
        out = torch.empty((src.shape[0], t.ny * t.h_loc, t.nx * t.w_loc), dtype=torch.uint8,
                          device=frames.device)
        return unpack_core(f, out, t)

    def _display(self, frames: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        m, g, t = self.mesh, self.geo, self.tiling
        ext = self.extend(frames)
        cores = []
        for k in range(ext.shape[0]):
            i, j = ((0, 0) if m.distributed else ((k // m.cols) % m.rows, k % m.cols))
            (buf,) = ff_stages(ext[k].contiguous(), thresholds, (self.final_stage,),
                               origin=t.ext_origin(i, j), image_size=t.image,
                               **ff_kwargs(self.cfg))
            cores.append(buf[g.e_top:g.e_top + g.h_loc, g.e_left:g.e_left + g.w_loc])
        out = torch.stack(cores)
        return out if m.distributed else _merge_tiles(out, m.rows, m.cols)


def build_sharded_pipeline(
    cfg: CannyConfig,
    mesh: TileMesh,
    final_stage: CannyStage = CannyStage.HYSTER,
    local_saturate: Optional[LocalSaturate] = None,
) -> ShardedPipeline:
    """The pipeline to ``final_stage`` sharded over ``mesh``: frames are
    (B, H, W[, C]) uint8 with H % rows == 0 and W % cols == 0 (and B a
    multiple of the mesh batch). ``local_saturate`` replaces the local
    operator of the round loop (default: K9 on the default schedule)."""
    return ShardedPipeline(cfg, mesh, final_stage, local_saturate)


def shard_frame(frames: torch.Tensor, mesh: TileMesh,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """A (B, H, W[, C]) frame batch as the pipeline takes it on ``mesh``:
    on one card the batch on ``device``; across processes this process's
    tile of its part of the batch, on the transport's device."""
    if not mesh.distributed:
        return frames.to(device if device is not None else frames.device).contiguous()
    b, h, w = frames.shape[:3]
    bi, i, j = mesh.coords()
    nb, hl, wl = b // mesh.batch, h // mesh.rows, w // mesh.cols
    part = frames[bi * nb:(bi + 1) * nb, i * hl:(i + 1) * hl, j * wl:(j + 1) * wl]
    return part.to(mesh.transport.device).contiguous()
