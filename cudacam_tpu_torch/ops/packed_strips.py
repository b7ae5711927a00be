"""The packed-strip format of the sharded hysteresis: the geometry of an
extended tile's packed planes, the extraction and OR placement of 32-row
bit strips, and one halo refresh with an injected neighbour hop.

Port of the strip half of ``cudacam_tpu/parallel/packed_halo.py``
(``PackedGeo`` :55, ``make_geo`` :81, ``_extract32`` :124, ``_or_place32``
:150, ``exchange_packed`` :195). Each tile holds its (FINAL, CANDIDATE)
planes packed over an EXTENDED tile: halo slots of 32 rows above and below
and 64 columns left and right of the owned core (clamped to the core, and
none on a mesh axis with one tile). A refresh exchanges packed strips (one
32-row word strip per vertical side, spanning all lanes; then 64 lanes per
horizontal side, spanning all word rows, so the corners travel too) and ORs
them into the neighbours' halo slots. OR is sound: every exchanged bit is a
promotion below the global fixed point, and promotion is monotone.

Layout: a tile's planes are (ceil(ext_h / 32), ext_w) int32 words holding
the uint32 bits, bit b of word [k, c] being extended pixel (32 k + b, c):
the port's plane layout everywhere. The TPU's guard word row and DMA
granule padding do not exist here. A batch of tiles is a leading axis, in
(b, y, x) mesh order.

The functions here are plain PyTorch on any device, with the neighbour hop
injected as ``shift`` (the JAX package injects ``permute``): on one card the
hop is an index shift over the tile axis (:func:`local_shift`); across
processes it is a send and a receive (``parallel/mesh.py``). On a CUDA
tensor of a one-card mesh the refresh is the kernel ``csrc/halo.cu``
(``ops/cuda/halo.py``); :func:`exchange_packed` is its plain version. The
collective round loop that drives the refreshes is
``parallel/packed_halo.py``.

Integer semantics: torch's int32 ``>>`` is arithmetic, so strips are shifted
as int64 words in [0, 2^32) and masked (``ops/bitpack.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from cudacam_tpu_torch.ops.bitpack import from_words, to_words

_MASK = 0xFFFFFFFF

#: ``shift(send_down, send_up, axis)`` -> ``(recv_top, recv_bot)``: for every
#: tile, the strip its predecessor on mesh axis ``axis`` ('y' or 'x') sent
#: down and the strip its successor sent up, zeros where there is none.
Shift = Callable[[torch.Tensor, torch.Tensor, str], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class PackedGeo:
    """Extended-tile packed-plane geometry of one tile."""

    h_loc: int
    w_loc: int
    e_top: int
    e_bot: int
    e_left: int
    e_right: int

    @property
    def ext_h(self) -> int:
        return self.e_top + self.h_loc + self.e_bot

    @property
    def ext_w(self) -> int:
        return self.e_left + self.w_loc + self.e_right

    @property
    def hw(self) -> int:
        """Word rows covering the extended tile: the planes' rows."""
        return -(-self.ext_h // 32)


def make_geo(h_loc: int, w_loc: int, ny: int = 2, nx: int = 2) -> PackedGeo:
    """Geometry of an (h_loc, w_loc) owned tile on an (ny, nx) tile grid:
    halo slots of 32 rows and 64 columns, clamped to the tile (a tile only
    exports state it owns), and none on an axis with one tile, so a
    (1, 1, 1) mesh carries the raw frame."""
    e_top = min(32, h_loc) if ny > 1 else 0
    e_left = min(64, w_loc) if nx > 1 else 0
    return PackedGeo(h_loc, w_loc, e_top, e_top, e_left, e_left)


# --- bit-strip extraction and placement (static offsets) -------------------


def _extract32(x: torch.Tensor, b: int) -> torch.Tensor:
    """The (..., lanes) int32 strip of extended rows [b, b + 32) of the
    (..., rows, lanes) plane ``x``. ``b`` may be negative down to -31 (rows
    before the plane read as zero) and must start inside the plane."""
    rows = x.shape[-2]
    if b <= -32:
        raise ValueError(f"strip offset {b} <= -32 (contract: b > -32)")
    if b >= 32 * rows:
        raise ValueError(f"strip offset {b} starts past the plane ({rows} word rows)")
    w = to_words(x)
    if b < 0:
        return from_words((w[..., 0, :] << -b) & _MASK)
    q, r = divmod(b, 32)
    row = w[..., q, :]
    if r:
        nxt = w[..., q + 1, :] if q + 1 < rows else torch.zeros_like(row)
        row = (row >> r) | ((nxt << (32 - r)) & _MASK)
    return from_words(row)


def _word_mask(b: int, cap_bits: int, word_idx: int) -> int:
    """The bits of word ``word_idx`` that lie in rows [b, min(cap, b + 32))."""
    lo = max(b, word_idx * 32) - word_idx * 32
    hi = min(cap_bits, b + 32, (word_idx + 1) * 32) - word_idx * 32
    if hi <= lo:
        return 0
    return _MASK if hi - lo >= 32 else ((1 << (hi - lo)) - 1) << lo


def _or_place32(
    x: torch.Tensor, strip: torch.Tensor, b: int, cap_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OR a 32-row strip into rows [b, b + 32) of the (..., rows, lanes)
    plane ``x``, dropping bits at rows outside [0, cap_bits). Returns the new
    plane and, per leading index, whether a bit was new."""
    lead = x.shape[:-2]
    w, s = to_words(x), to_words(strip)
    if b < 0:
        s = s >> -b
        b = 0
    new = torch.zeros(lead, dtype=torch.bool, device=x.device)
    if b >= cap_bits:
        return x, new
    q, r = divmod(b, 32)
    w = w.clone()
    lo_part = ((s << r) & _MASK if r else s) & _word_mask(b, cap_bits, q)
    new = new | (lo_part & ~w[..., q, :] & _MASK).ne(0).any(-1)
    w[..., q, :] |= lo_part
    if r and q + 1 < x.shape[-2]:
        hi_part = (s >> (32 - r)) & _word_mask(b, cap_bits, q + 1)
        new = new | (hi_part & ~w[..., q + 1, :] & _MASK).ne(0).any(-1)
        w[..., q + 1, :] |= hi_part
    return from_words(w), new


# --- the exchange ------------------------------------------------------------


def local_shift(ny: int, nx: int) -> Shift:
    """The neighbour hop of a one-card mesh: tiles are the leading axis of
    one tensor in (b, y, x) order, and a hop is an index shift over it."""

    def shift(down: torch.Tensor, up: torch.Tensor, axis: str):
        dim = 1 if axis == "y" else 2
        d = down.reshape((-1, ny, nx) + tuple(down.shape[1:]))
        u = up.reshape((-1, ny, nx) + tuple(up.shape[1:]))
        n = d.shape[dim]
        top, bot = torch.zeros_like(d), torch.zeros_like(u)
        top.narrow(dim, 1, n - 1).copy_(d.narrow(dim, 0, n - 1))
        bot.narrow(dim, 0, n - 1).copy_(u.narrow(dim, 1, n - 1))
        return top.reshape(down.shape), bot.reshape(up.shape)

    return shift


def exchange_packed(
    x: torch.Tensor, geo: PackedGeo, ny: int, nx: int, shift: Shift
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One halo refresh of the (T, hw, ext_w) planes ``x``: OR each
    neighbour's boundary strips into each tile's halo slots. Returns (planes,
    (T,) any new bit). Rows first, over all lanes; then columns over all word
    rows, carrying the corners just placed. Strips map by global pixel
    position, so a strip may carry halo bits its sender received: valid
    promotions below the fixed point."""
    new = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    cap = geo.ext_h
    if ny > 1:
        send_down = _extract32(x, geo.e_top + geo.h_loc - 32)  # -> the lower tile's top slot
        send_up = _extract32(x, geo.e_top)  # -> the upper tile's bottom slot
        recv_top, recv_bot = shift(send_down, send_up, "y")
        x, n1 = _or_place32(x, recv_top, geo.e_top - 32, cap)
        x, n2 = _or_place32(x, recv_bot, geo.e_top + geo.h_loc, cap)
        new = new | n1 | n2
    if nx > 1:
        k = min(64, geo.e_left)  # strip lanes (the slot depth)
        c_r = geo.e_left + geo.w_loc
        send_right = x[..., c_r - k:c_r]
        send_left = x[..., geo.e_left:geo.e_left + k]
        recv_left, recv_right = shift(send_right, send_left, "x")
        old_l = x[..., geo.e_left - k:geo.e_left]
        old_r = x[..., c_r:c_r + k]
        new = new | (recv_left & ~old_l).ne(0).flatten(1).any(1)
        new = new | (recv_right & ~old_r).ne(0).flatten(1).any(1)
        x = x.clone()
        x[..., geo.e_left - k:geo.e_left] = old_l | recv_left
        x[..., c_r:c_r + k] = old_r | recv_right
    return x, new
