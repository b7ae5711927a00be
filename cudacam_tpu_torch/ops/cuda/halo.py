"""The halo exchange of a one-card mesh: every tile's packed strips in one
launch.

Wraps ``csrc/halo.cu``, which replaces the strip exchange of the sharded
round loop. The JAX package computes it as XLA ops around
``jax.lax.ppermute`` (cudacam_tpu/parallel/packed_halo.py:
``exchange_packed`` :195, ``_extract32`` :124, ``_or_place32`` :150) with a
``psum``'d flag (``packed_hysteresis_loop`` :288-306); as plain torch ops it
would be about 30 launches per round. On one card every tile of the
(b, y, x) mesh is a slice of one tensor, so the kernel refreshes every
tile in one cooperative launch: each band publishes what its tile's
neighbours read of it, one grid barrier, each band ORs its halo words in
(``csrc/halo.cuh``), then the pending flag after a second barrier. The
round loop kernel (``parallel/packed_halo.py::sharded_loop``) runs the same
device functions in its own launch, so the one-card sharded HYSTER call
never launches this one; the host loop with an injected local operator
does, once a round. Its plain version is
``ops/packed_strips.py::exchange_packed`` with the index-shift hop.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)
from cudacam_tpu_torch.ops.packed_strips import PackedGeo, exchange_packed, local_shift


@functools.lru_cache(maxsize=None)
def _scratch_words(tiles: int, hw: int, w: int) -> int:
    return load().lib.cc_exchange_scratch_words(tiles, hw, w)


def _check(x, grid, geo, grow, pending) -> None:
    nb, ny, nx = grid
    want = (nb * ny * nx, geo.hw, geo.ext_w)
    if x.dtype != torch.int32 or tuple(x.shape) != want:
        raise ValueError(f"planes must be a {want} int32 tensor, got {tuple(x.shape)} {x.dtype}")
    if grow is not None and grow.ndim != 1:
        raise ValueError("grow must be a 1-D tensor")
    if pending is not None and (pending.dtype != torch.int32 or pending.numel() != 1):
        raise ValueError("pending must be a one-element int32 tensor")


def halo_exchange_plain(
    x: torch.Tensor,
    grid: Tuple[int, int, int],
    geo: PackedGeo,
    *,
    grow: Optional[torch.Tensor] = None,
    pending: Optional[torch.Tensor] = None,
) -> None:
    """Plain PyTorch version of :func:`halo_exchange`, on any device:
    ``exchange_packed`` with the index-shift hop."""
    _, ny, nx = grid
    out, new = exchange_packed(x, geo, ny, nx, local_shift(ny, nx))
    x.copy_(out)
    if pending is not None:
        grown = grow is not None and bool(grow.ne(0).any())
        pending.fill_(int(grown or bool(new.any())))


def halo_exchange(
    x: torch.Tensor,
    grid: Tuple[int, int, int],
    geo: PackedGeo,
    *,
    grow: Optional[torch.Tensor] = None,
    pending: Optional[torch.Tensor] = None,
) -> None:
    """One halo refresh of the (nb ny nx, hw, ext_w) planes of every tile of
    a (nb, ny, nx) one-card mesh, in place. ``pending`` (one int32) becomes
    1 when a tile of ``grow`` (1-D, nonzero = still growing) grows or a halo
    bit was new, else 0."""
    _check(x, grid, geo, grow, pending)
    if use_plain(x, grow, pending):
        halo_exchange_plain(x, grid, geo, grow=grow, pending=pending)
        return
    if grow is not None and grow.dtype != torch.int32:
        grow = grow.to(torch.int32)
    require_contiguous(x, *([pending] if pending is not None else []))
    scratch = torch.empty(_scratch_words(x.shape[0], geo.hw, geo.ext_w), dtype=torch.int32,
                          device=x.device)
    nb, ny, nx = grid
    lib = load()
    lib.check(
        lib.lib.cc_halo_exchange(
            x.data_ptr(), scratch.data_ptr(), grow.data_ptr() if grow is not None else None,
            grow.numel() if grow is not None else 0, grow.stride(0) if grow is not None else 0,
            pending.data_ptr() if pending is not None else None, nb, ny, nx, geo.hw, geo.ext_w,
            geo_args(geo), x.device.index, stream_of(x),
        ),
        "halo_exchange",
    )
    count_launch("halo_exchange")


def geo_args(geo: PackedGeo) -> ctypes.Array:
    """The geometry as the C entry points take it: 5 ints (e_top, h_loc,
    e_left, w_loc, ext_h)."""
    return (ctypes.c_int * 5)(geo.e_top, geo.h_loc, geo.e_left, geo.w_loc, geo.ext_h)
